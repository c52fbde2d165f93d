// Windowed multi-head attention forward for Hopper (sm_90a), bf16, on the
// tensor cores (warp-level mma.sync m16n8k16, bf16 operands, fp32
// accumulators, fed by ldmatrix), for N <= 144.  (bf16 at 144 < N <= 352
// runs window_attention_tc_long.cu; fp32, and bf16 at hd = 128 or beyond
// N = 352, window_attention.cu on the CUDA cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas
// (body _packed_kernel).  For every (batch, window, head)
//
//     out = softmax(round(q * hd^-1/2) . k^T + bias[window, head]) . v
//
// with q, k, v read straight out of the packed (B, nW, N, 3C) qkv rows at
// channel offsets head*hd, C + head*hd and 2C + head*hd, the bias
// (nW, h, N, N) fp32 shared over the batch (its window axis may have a
// stride of 0), and the output written as (B, nW, N, C) bf16; the rounding
// steps are the plain version's (window_attention_tc.cuh).
//
// What bounds it on the card: bytes.  At the report shape (FIBER-Base 384^2
// stage 3 at the rerank's pair batch: B = 16, nW = 4, h = 16, N = 144,
// hd = 32) qkv and out in bf16 and the bias in fp32, each once, are 43 MB,
// 0.0129 ms at 3.35 TB/s; the two products are 2.72 GFLOP, 0.0028 ms at
// 989 TFLOP/s.  The first K1 (window_attention.cu: fp32 FMAs on the CUDA
// cores, one block per (window, head, batch element)) took 0.41 ms there,
// held by its shared-memory-fed FMAs and by reading the 83 KB bias tile of
// a (window, head) once per batch element.  Here:
// * the grid is (nW * h, S): block (w * h + head, s) stages the bias tile
//   once and walks the batch elements of split s in ascending order,
//   prefetching the next element's q, k, v while it computes the current
//   one.  The wrapper picks S with the backward's cost model (the fewest
//   splits whose waves times batch elements per block is near the least).
//   Every output element is written by one thread: no atomics, and two
//   calls give the same bits;
// * both products run on the tensor cores, one warp per 16-row query slab
//   (attend_heads_tc, window_attention_tc.cuh, shared with K4).
//
// Shared memory at N = 144, hd = 32: the bias tile 144 x 152 fp32 (87,552
// bytes) and two buffers of q, K, V at 144 x 40 bf16 (69,120), 156,672 in
// all: one block of 9 warps per SM.  Limits: N <= 144 (a slab's S row in
// registers) and hd in {8, 16, 32, 64} (211,968 bytes at N = 144, hd = 64).
// wgmma, TMA and warp specialisation are left for a later version.

#include <stdint.h>

#include "window_attention_tc.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

template <int HD>
__global__ void __launch_bounds__(kTcMaxWarps * 32, 1)
window_attention_fwd_tc_kernel(const bf16* __restrict__ qkv,
                               const float* __restrict__ bias,
                               bf16* __restrict__ out, int B, int nW, int N,
                               int h, long long bias_w_stride, float scale) {
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int C = h * HD;
  int b_begin, b_end;
  split_range(B, gridDim.y, blockIdx.y, &b_begin, &b_end);
  extern __shared__ __align__(16) unsigned char smem[];

  const size_t row0 = (size_t)w * N;  // window w's first token, element 0
  const PackedRows rows{qkv + row0 * 3 * C + head * HD,
                        out + row0 * C + head * HD,
                        (long long)nW * N * 3 * C, (long long)nW * N * C,
                        3LL * C, (long long)C, C};
  attend_heads_tc<HD>(rows, bias + (size_t)w * bias_w_stride + (size_t)head * N * N,
                      N, b_begin, b_end, scale, smem);
}

template <int HD>
cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int nW,
                   int N, int h, long long bias_w_stride, float scale,
                   int splits, cudaStream_t stream) {
  auto kernel = window_attention_fwd_tc_kernel<HD>;
  const size_t smem = attend_tc_smem_bytes(N, HD);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(nW * h, splits), attend_tc_threads(N), smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), B, nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; -1 where the shape is not taken.
long long fiber_window_attention_tc_smem_bytes(int N, int hd) {
  return attend_tc_takes(N, hd) ? (long long)attend_tc_smem_bytes(N, hd) : -1;
}

// Resident blocks per SM; -1 on error or where the shape is not taken.
int fiber_window_attention_tc_blocks_per_sm(int N, int hd) {
  if (!attend_tc_takes(N, hd)) return -1;
  const size_t smem = attend_tc_smem_bytes(N, hd);
  const int threads = attend_tc_threads(N);
  switch (hd) {
    case 8: return blocks_per_sm(window_attention_fwd_tc_kernel<8>, threads, smem);
    case 16: return blocks_per_sm(window_attention_fwd_tc_kernel<16>, threads, smem);
    case 32: return blocks_per_sm(window_attention_fwd_tc_kernel<32>, threads, smem);
    default: return blocks_per_sm(window_attention_fwd_tc_kernel<64>, threads, smem);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// qkv (B, nW, N, 3 h hd) and out (B, nW, N, h hd) contiguous bf16, 16-byte
// aligned; bias fp32, element (w, head, i, j) at w * bias_w_stride +
// (head * N + i) * N + j, 16-byte aligned; 1 <= splits <= B.
int fiber_window_attention_tc_fwd(const void* qkv, const void* bias, void* out,
                                  int B, int nW, int N, int h, int hd,
                                  long long bias_w_stride, float scale,
                                  int splits, void* stream) {
  if (!attend_tc_takes(N, hd) || splits < 1 || splits > B) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return (int)launch<8>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 16: return (int)launch<16>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 32: return (int)launch<32>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
    default: return (int)launch<64>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, splits, s);
  }
}

}  // extern "C"
