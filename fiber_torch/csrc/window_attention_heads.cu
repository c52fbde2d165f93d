// Windowed multi-head attention forward in the per-head layout, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::_kernel_call (body _kernel).  It
// computes K1's function, for every (batch, window, head)
//
//     out = softmax(q * hd^-1/2 . k^T + bias[window, head]) . v
//
// on per-head operands: q, k, v and out are (B, nW, h, N, hd), each
// contiguous, the bias (nW, h, N, N) fp32 shared over the batch (its window
// axis may have a stride of 0).  The rounding is K1's: q scaled and rounded
// to the input dtype before the product, fp32 logits and softmax, the
// probabilities rounded to the input dtype before P.V, P.V in fp32.
//
// What bounds it on the card: bytes, as for K1 (3 N hd inputs, N hd outputs
// and N^2 fp32 bias values per (b, w, head) against 4 N^2 hd FLOP).  The
// per-head layout makes every row read contiguous (hd values); the
// head-split transpose that produces it is the caller's, outside the
// kernel.  The TPU kernel's WB windows per program batch the MXU products;
// that is a TPU device and is dropped.  One block per (window, head) x
// batch runs `attend_head` (window_attention_common.cuh), the routine K1
// runs, on the per-head strides; fp32 CUDA-core FMAs.
//
// Limits: K1's (N <= 352, hd in {8, 16, 32, 64, 128}, fp32 or bf16, K and V
// within a block's shared memory; the wrapper checks and raises).  N <= 256
// runs attend_head with 8 key chunks a lane; 256 < N <= 352 (FIBER's
// 18 x 18 windows at 576^2) a second instance with 11, as K1 does.  The
// wrapper sends this kernel fp32 and bf16 at hd = 128 only: bf16 at
// hd <= 64 runs on the tensor cores, window_attention_heads_tc.cu up to
// N = 144 and window_attention_heads_tc_long.cu beyond.

#include <stdint.h>

#include "window_attention_common.cuh"

namespace {

using namespace fiber;

constexpr int kWarps = 8;

template <typename T>
__host__ __device__ inline size_t smem_bytes(int N, int hd) {
  return attend_smem_bytes<T>(N, hd, kWarps);
}

template <typename T, int HD, int KC>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_heads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ bias,
                              T* __restrict__ out, int nW, int N, int h,
                              long long bias_w_stride, float scale) {
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int b = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem[];

  const size_t off = ((((size_t)b * nW + w) * h + head) * N) * HD;
  attend_head<T, HD, false, false, KC>(
      q + off, k + off, v + off, HD, out + off, HD,
      bias + (size_t)w * bias_w_stride + (size_t)head * N * N, nullptr, N,
      scale, smem, kWarps);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int nW, int N, int h,
                   long long bias_w_stride, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, HD);
  auto kernel = N <= 32 * kMaxKeyChunks
      ? window_attention_heads_kernel<T, HD, kMaxKeyChunks>
      : window_attention_heads_kernel<T, HD, kLongKeyChunks>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(nW * h, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, int B, int nW, int N,
                        int h, int hd, long long bias_w_stride, float scale,
                        cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, s);
    case 16: return launch<T, 16>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, s);
    case 32: return launch<T, 32>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, s);
    case 64: return launch<T, 64>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, s);
    case 128: return launch<T, 128>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = fp32, 1 = bf16.
long long fiber_window_attention_heads_smem_bytes(int N, int hd, int dtype) {
  return (long long)(dtype == 0 ? smem_bytes<float>(N, hd)
                                : smem_bytes<__nv_bfloat16>(N, hd));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v and out (B, nW, h, N, hd) contiguous in `dtype`; bias fp32,
// element (w, head, i, j) at w * bias_w_stride + (head * N + i) * N + j.
int fiber_window_attention_heads_fwd(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int B, int nW, int N, int h,
                                     int hd, long long bias_w_stride,
                                     float scale, int dtype, void* stream) {
  if (N < 1 || N > 32 * kLongKeyChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_hd<float>(q, k, v, bias, out, B, nW, N, h, hd, bias_w_stride, scale, s)
      : dispatch_hd<__nv_bfloat16>(q, k, v, bias, out, B, nW, N, h, hd, bias_w_stride, scale, s);
  return (int)e;
}

}  // extern "C"
