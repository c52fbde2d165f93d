// Windowed multi-head attention forward in the per-head layout for Hopper
// (sm_90a), bf16, on the tensor cores, for N <= 144.  (bf16 at 144 < N <=
// 352 runs window_attention_heads_tc_long.cu; fp32, and bf16 at hd = 128,
// window_attention_heads.cu on the CUDA cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::_kernel_call (body _kernel).  It
// computes K1's function on per-head operands: q, k, v and out are
// (B, nW, h, N, hd) bf16, each contiguous, the bias (nW, h, N, N) fp32
// shared over the batch (its window axis may have a stride of 0).
//
// What bounds it on the card: bytes, as for K1 (3 N hd inputs, N hd outputs
// and N^2 fp32 bias values per (b, w, head) against 4 N^2 hd FLOP).  The
// design is K1's tensor-core kernel (window_attention_tc.cu): a grid
// (nW * h, S) whose block stages its (window, head)'s bias tile once and
// walks the batch elements of its split, running attend_heads_tc
// (window_attention_tc.cuh) on the per-head strides (rows of hd values).
// The TPU kernel's WB windows per program batch the MXU products; that is
// a TPU device and is dropped.  Limits: K1's tensor-core route's (N <= 144,
// hd in {8, 16, 32, 64}).

#include <stdint.h>

#include "window_attention_tc.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

template <int HD>
__global__ void __launch_bounds__(kTcMaxWarps * 32, 1)
window_attention_heads_tc_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const float* __restrict__ bias,
                                 bf16* __restrict__ out, int B, int nW, int N,
                                 int h, long long bias_w_stride, float scale) {
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  int b_begin, b_end;
  split_range(B, gridDim.y, blockIdx.y, &b_begin, &b_end);
  extern __shared__ __align__(16) unsigned char smem[];

  const size_t off = (size_t)blockIdx.x * N * HD;  // (0, w, head), row 0
  const HeadRows rows{q + off, k + off, v + off, out + off,
                      (long long)nW * h * N * HD, HD, HD};
  attend_heads_tc<HD>(rows, bias + (size_t)w * bias_w_stride + (size_t)head * N * N,
                      N, b_begin, b_end, scale, smem);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int nW, int N, int h,
                   long long bias_w_stride, float scale, int splits,
                   cudaStream_t stream) {
  auto kernel = window_attention_heads_tc_kernel<HD>;
  const size_t smem = attend_tc_smem_bytes(N, HD);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(nW * h, splits), attend_tc_threads(N), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), B, nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; -1 where the shape is not taken.
long long fiber_window_attention_heads_tc_smem_bytes(int N, int hd) {
  return attend_tc_takes(N, hd) ? (long long)attend_tc_smem_bytes(N, hd) : -1;
}

// Resident blocks per SM; -1 on error or where the shape is not taken.
int fiber_window_attention_heads_tc_blocks_per_sm(int N, int hd) {
  if (!attend_tc_takes(N, hd)) return -1;
  const size_t smem = attend_tc_smem_bytes(N, hd);
  const int threads = attend_tc_threads(N);
  switch (hd) {
    case 8: return blocks_per_sm(window_attention_heads_tc_kernel<8>, threads, smem);
    case 16: return blocks_per_sm(window_attention_heads_tc_kernel<16>, threads, smem);
    case 32: return blocks_per_sm(window_attention_heads_tc_kernel<32>, threads, smem);
    default: return blocks_per_sm(window_attention_heads_tc_kernel<64>, threads, smem);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v and out (B, nW, h, N, hd) contiguous bf16, 16-byte aligned; bias
// fp32, element (w, head, i, j) at w * bias_w_stride + (head * N + i) * N
// + j, 16-byte aligned; 1 <= splits <= B.
int fiber_window_attention_heads_tc_fwd(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* out, int B, int nW, int N, int h,
                                        int hd, long long bias_w_stride,
                                        float scale, int splits, void* stream) {
  if (!attend_tc_takes(N, hd) || splits < 1 || splits > B) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return (int)launch<8>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 16: return (int)launch<16>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 32: return (int)launch<32>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
    default: return (int)launch<64>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
  }
}

}  // extern "C"
