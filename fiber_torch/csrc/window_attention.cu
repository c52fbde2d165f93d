// Windowed multi-head attention forward for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas
// (body _packed_kernel).  It computes, for every (batch, window, head),
//
//     out = softmax(q * hd^-1/2 . k^T + bias[window, head]) . v
//
// with q, k, v read straight out of the packed (B, nW, N, 3C) qkv rows at
// channel offsets head*hd, C + head*hd and 2C + head*hd, the bias
// (nW, h, N, N) fp32 shared over the batch, and the output written as
// (B, nW, N, C) in the input dtype.  The rounding follows the plain
// PyTorch version (fiber_torch/ops/window_attention.py): q is scaled and
// rounded to the input dtype before the product, logits and softmax are
// fp32, the probabilities are rounded to the input dtype before P.V, and
// P.V accumulates in fp32.
//
// What bounds it on the card: bytes.  At the FIBER-Base 384^2 shapes
// (N = 144, hd = 32) one (b, w, head) does 2 * 2 * N^2 * hd = 2.65 MFLOP
// on 3 * N * hd inputs, N * hd outputs and N^2 fp32 bias values; the bias
// alone is 83 KB per (w, head), so qkv, out and bias traffic is what the
// card waits on, not arithmetic.  What this first design does about it:
// every input byte is read from device memory once per block (K and V
// staged in shared memory, bias rows read coalesced straight into the
// logits, no head-split transpose and no (N, N) logits matrix written out),
// and a bias shared by all windows can be passed with a window stride of 0
// so that it is not materialised nW times.  The head packing of the TPU
// kernel (G = 128 / hd heads per MXU product) is a TPU device and is
// dropped; products run on the CUDA cores in fp32.  Tensor cores (wgmma)
// and TMA are left for a later version.
//
// Limits: N <= 256 and hd in {8, 16, 32, 64, 128}, fp32 or bf16, as long
// as K and V fit in a block's shared memory (all but fp32 at N = 256 with
// hd = 128; the wrapper checks and raises).
//
// Layout of the work: one block per (window, head) x batch, 8 warps; one
// warp owns one query row at a time.  The lanes split the N keys (N <= 256,
// so at most 8 keys per lane, masked at the tail), reduce max and sum with
// warp shuffles, and for P.V each lane owns hd / 32 output channels (for
// hd < 32 the lanes split the keys into 32 / hd groups and reduce).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxKeyChunks = 8;  // N <= 32 * 8 = 256

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

// Row stride of the staged K, in elements: an odd number of 32-bit words,
// so that 32 lanes reading 32 different rows hit 32 different banks.
template <typename T> __host__ __device__ constexpr int k_stride(int hd) {
  return sizeof(T) == 4 ? hd + 1 : hd + 2;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int N, int hd) {
  return align16(sizeof(T) * (size_t)N * k_stride<T>(hd))   // K
       + align16(sizeof(T) * (size_t)N * hd)                // V
       + align16(sizeof(float) * (size_t)kWarps * hd)       // one q row per warp
       + align16(sizeof(float) * (size_t)kWarps * N);       // one p row per warp
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

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_fwd_kernel(const T* __restrict__ qkv,
                            const float* __restrict__ bias,
                            T* __restrict__ out,
                            int nW, int N, int h, long long bias_w_stride,
                            float scale) {
  constexpr int KS = k_stride<T>(HD);
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int b = blockIdx.y;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + align16(sizeof(T) * (size_t)N * KS));
  float* Qs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Vs) + align16(sizeof(T) * (size_t)N * HD));
  float* Ps = Qs + align16(sizeof(float) * kWarps * HD) / sizeof(float);
  float* q_row = Qs + warp * HD;
  float* p_row = Ps + warp * N;

  const size_t row0 = ((size_t)b * nW + w) * N;  // first token of the window
  const T* win = qkv + row0 * 3 * C;

  // Stage this head's K and V (N x hd each) in shared memory.
  for (int i = threadIdx.x; i < N * HD; i += blockDim.x) {
    const int n = i / HD;
    const int d = i - n * HD;
    const T* row = win + (size_t)n * 3 * C + head * HD + d;
    Ks[n * KS + d] = row[C];
    Vs[n * HD + d] = row[2 * C];
  }
  __syncthreads();

  const float* bias_wh = bias + (size_t)w * bias_w_stride + (size_t)head * N * N;
  T* out_win = out + row0 * C + head * HD;

  for (int n = warp; n < N; n += kWarps) {
    const T* q_src = win + (size_t)n * 3 * C + head * HD;
    for (int d = lane; d < HD; d += 32)
      q_row[d] = to_float(from_float<T>(to_float(q_src[d]) * scale));
    __syncwarp();

    // Logits: lane owns keys j = lane + 32 t.
    const float* bias_row = bias_wh + (size_t)n * N;
    float logit[kMaxKeyChunks];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      logit[t] = -INFINITY;
      if (j < N) {
        const T* kr = Ks + j * KS;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(q_row[d], to_float(kr[d]), acc);
        logit[t] = acc + bias_row[j];
        mx = fmaxf(mx, logit[t]);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        logit[t] = expf(logit[t] - mx);
        sum += logit[t];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < N) p_row[j] = to_float(from_float<T>(logit[t] / sum));
    }
    __syncwarp();

    // P.V in fp32.
    T* o = out_win + (size_t)n * C;
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

template <typename T, int HD>
cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int nW,
                   int N, int h, long long bias_w_stride, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, HD);
  auto kernel = window_attention_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(nW * h, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<T*>(out), nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* qkv, const void* bias, void* out, int B,
                        int nW, int N, int h, int hd, long long bias_w_stride,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, stream);
    case 16: return launch<T, 16>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, stream);
    case 32: return launch<T, 32>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, stream);
    case 64: return launch<T, 64>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, stream);
    case 128: return launch<T, 128>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = fp32, 1 = bf16.
long long fiber_window_attention_smem_bytes(int N, int hd, int dtype) {
  return (long long)(dtype == 0 ? smem_bytes<float>(N, hd)
                                : smem_bytes<__nv_bfloat16>(N, hd));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// qkv (B, nW, N, 3 h hd) and out (B, nW, N, h hd) contiguous in `dtype`;
// bias fp32, element (w, head, i, j) at w * bias_w_stride + (head * N + i) * N + j.
int fiber_window_attention_fwd(const void* qkv, const void* bias, void* out,
                               int B, int nW, int N, int h, int hd,
                               long long bias_w_stride, float scale, int dtype,
                               void* stream) {
  if (N < 1 || N > 32 * kMaxKeyChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_hd<float>(qkv, bias, out, B, nW, N, h, hd, bias_w_stride, scale, s)
      : dispatch_hd<__nv_bfloat16>(qkv, bias, out, B, nW, N, h, hd, bias_w_stride, scale, s);
  return (int)e;
}

}  // extern "C"
