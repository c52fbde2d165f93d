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
// Limits: N <= 352 and hd in {8, 16, 32, 64, 128}, fp32 or bf16, as long
// as K and V fit in a block's shared memory (not fp32 at N = 256 with
// hd = 128; the wrapper checks and raises).  N <= 256 runs attend_head with
// 8 key chunks a lane, the instance K3 and K4 share; 256 < N <= 352 (FIBER's
// 18 x 18 windows at 576^2, in fp32) a second instance with 11.
//
// Layout of the work: one block per (window, head) x batch, 8 warps, each
// running `attend_head` (window_attention_common.cuh, shared with K3 and
// K4): one warp owns one query row at a time, the lanes split the keys.

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
window_attention_fwd_kernel(const T* __restrict__ qkv,
                            const float* __restrict__ bias,
                            T* __restrict__ out,
                            int nW, int N, int h, long long bias_w_stride,
                            float scale) {
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int b = blockIdx.y;
  const int C = h * HD;
  extern __shared__ __align__(16) unsigned char smem[];

  const size_t row0 = ((size_t)b * nW + w) * N;  // first token of the window
  const T* q = qkv + row0 * 3 * C + head * HD;
  attend_head<T, HD, false, false, KC>(
      q, q + C, q + 2 * C, 3 * C, out + row0 * C + head * HD, C,
      bias + (size_t)w * bias_w_stride + (size_t)head * N * N, nullptr, N,
      scale, smem, kWarps);
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int nW,
                   int N, int h, long long bias_w_stride, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, HD);
  auto kernel = N <= 32 * kMaxKeyChunks
      ? window_attention_fwd_kernel<T, HD, kMaxKeyChunks>
      : window_attention_fwd_kernel<T, HD, kLongKeyChunks>;
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
  if (N < 1 || N > 32 * kLongKeyChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_hd<float>(qkv, bias, out, B, nW, N, h, hd, bias_w_stride, scale, s)
      : dispatch_hd<__nv_bfloat16>(qkv, bias, out, B, nW, N, h, hd, bias_w_stride, scale, s);
  return (int)e;
}

}  // extern "C"
