// Windowed multi-head attention forward in the per-head layout for Hopper
// (sm_90a), bf16, on the tensor cores, for windows of 144 < N <= 352
// tokens: FIBER's 18 x 18 windows (N = 324) at 576^2, the rerank tail's
// stage 3 there (fiber_torch/tools/profile_tail.py).  (N <= 144 runs
// window_attention_heads_tc.cu; fp32 and hd = 128
// window_attention_heads.cu on the CUDA cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::_kernel_call (body _kernel) at those
// window sizes.  It computes K1's function on per-head operands: q, k, v
// and out are (B, nW, h, N, hd) bf16, each contiguous, the bias (nW, h, N,
// N) fp32 shared over the batch (its window axis may have a stride of 0),
// with the rounding steps of the plain version
// window_attention_heads_reference (fiber_torch/ops/window_attention.py).
//
// What bounds it on the card: bytes, as for K1 (3 N hd inputs, N hd outputs
// and N^2 fp32 bias values per (b, w, head) against 4 N^2 hd FLOP): at
// stage 1 of 576^2 at B = 4 (nW 16, h 4) 0.057 ms at 3.35 TB/s.  The design
// is K1's long-window kernel (window_attention_tc_long.cu): the same
// two-pass routine attend_long (window_attention_tc_long.cuh) on the same
// (ceil(N / R), nW h, S) grid, R query rows a block and `parts` warps a
// 16-row slab, from the same plan (_long_plan); only the row accessor
// differs (HeadRows: rows of hd values), so K1 and K4 give the same bits
// for the same (window, head).  The TPU kernel's WB windows per program
// batch the MXU products; that is a TPU device and is dropped.
// Limits: attend_long's (N <= 352, hd in {8, 16, 32, 64}, R a multiple of
// 16, R / 16 x parts <= 16 warps, within a block's shared memory).

#include <stdint.h>

#include "window_attention_tc_long.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

template <int HD>
__global__ void __launch_bounds__(kLongMaxThreads, 1)
window_attention_heads_tc_long_kernel(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const float* __restrict__ bias,
                                      bf16* __restrict__ out, int B, int nW,
                                      int N, int h, long long bias_w_stride,
                                      float scale, int parts) {
  const int w = blockIdx.y / h;
  const int head = blockIdx.y - w * h;
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);
  extern __shared__ __align__(16) unsigned char smem[];

  const size_t off = (size_t)blockIdx.y * N * HD;  // (0, w, head), row 0
  const HeadRows rows{q + off, k + off, v + off, out + off,
                      (long long)nW * h * N * HD, HD, HD};
  attend_long<HD>(rows, bias + (size_t)w * bias_w_stride + (size_t)head * N * N,
                  N, b_begin, b_end, scale, parts, smem);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int nW, int N, int h,
                   long long bias_w_stride, float scale, int R, int parts,
                   int splits, cudaStream_t stream) {
  auto kernel = window_attention_heads_tc_long_kernel<HD>;
  const size_t smem = FwdLongLayout(N, HD, R, parts).total();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((N + R - 1) / R, nW * h, splits), R / 16 * parts * 32, smem,
           stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v),
                     static_cast<const float*>(bias), static_cast<bf16*>(out),
                     B, nW, N, h, bias_w_stride, scale, parts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of R query rows on `parts` warps a slab needs;
// -1 where the shape is not taken.
long long fiber_window_attention_heads_tc_long_smem_bytes(int N, int hd, int R,
                                                          int parts) {
  return long_takes(N, hd, R, parts)
      ? (long long)FwdLongLayout(N, hd, R, parts).total() : -1;
}

// Resident blocks per SM; -1 on error or where the shape is not taken.
int fiber_window_attention_heads_tc_long_blocks_per_sm(int N, int hd, int R,
                                                       int parts) {
  if (!long_takes(N, hd, R, parts)) return -1;
  const size_t smem = FwdLongLayout(N, hd, R, parts).total();
  const int threads = R / 16 * parts * 32;
  switch (hd) {
    case 8: return blocks_per_sm(window_attention_heads_tc_long_kernel<8>, threads, smem);
    case 16: return blocks_per_sm(window_attention_heads_tc_long_kernel<16>, threads, smem);
    case 32: return blocks_per_sm(window_attention_heads_tc_long_kernel<32>, threads, smem);
    default: return blocks_per_sm(window_attention_heads_tc_long_kernel<64>, threads, smem);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v and out (B, nW, h, N, hd) contiguous bf16, 16-byte aligned; bias
// fp32, element (w, head, i, j) at w * bias_w_stride + (head * N + i) * N
// + j, 16-byte aligned; R query rows a block (a multiple of 16) on `parts`
// warps a 16-row slab; 1 <= splits <= B.
int fiber_window_attention_heads_tc_long_fwd(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             void* out, int B, int nW, int N,
                                             int h, int hd,
                                             long long bias_w_stride,
                                             float scale, int R, int parts,
                                             int splits, void* stream) {
  if (!long_takes(N, hd, R, parts) || splits < 1 || splits > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return (int)launch<8>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
    case 16: return (int)launch<16>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
    case 32: return (int)launch<32>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
    default: return (int)launch<64>(q, k, v, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
  }
}

}  // extern "C"
