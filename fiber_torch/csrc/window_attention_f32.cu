// Windowed multi-head attention forward for Hopper (sm_90a), fp32 at hd in
// {8, 16, 32, 64}, on the CUDA cores, register-tiled: K1's fp32 route
// ("f32_tiled").  (bf16 runs window_attention_tc.cu and
// window_attention_tc_long.cu; fp32 at hd = 128 window_attention.cu.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas (body
// _packed_kernel) in fp32: for every (batch, window, head)
//
//     out = softmax(q * hd^-1/2 . k^T + bias[window, head]) . v
//
// on the packed (B, nW, N, 3C) qkv rows (q, k, v at channel offsets
// head hd, C + head hd, 2C + head hd), the (nW, h, N, N) fp32 bias (its
// window axis may have a stride of 0) and the (B, nW, N, C) output.  It
// runs attend_f32 (window_attention_f32.cuh): the operations of the plain
// version window_attention_reference on the card, in its order, with 8
// query rows a warp; the header says why these bits and what bounds it.
//
// Grid (ceil(N / 8 warps), nW h, S): block (r, w h + head, s) runs query
// rows [8 warps r, 8 warps (r + 1)) for the batch elements of split s; the
// wrapper's plan (`_f32_plan`) gives warps and S.

#include <stdint.h>

#include "window_attention_f32.cuh"

namespace {

using namespace fiber;

struct Args {
  const float* qkv;
  const float* bias;
  float* out;
  int B, nW, N, h;
  long long bias_w_stride;
  float scale;
};

template <int HD, int KC>
__global__ void __launch_bounds__(kF32FwdMaxWarps * 32)
window_attention_f32_kernel(const Args a) {
  const int w = blockIdx.y / a.h;
  const int head = blockIdx.y - w * a.h;
  int b0, b1;
  split_range(a.B, gridDim.z, blockIdx.z, &b0, &b1);
  extern __shared__ __align__(16) float smem_f32[];
  const F32Rows rows =
      packed_rows(a.qkv, a.out, a.nW, a.N, a.h, HD, w, head);
  attend_f32<HD, KC>(rows, a.bias + (size_t)w * a.bias_w_stride
                               + (size_t)head * a.N * a.N,
                     a.N, blockIdx.x * kF32RowsWarp * (blockDim.x >> 5), b0,
                     b1, a.scale, smem_f32);
}

template <int HD, int KC>
cudaError_t launch_kc(const Args& a, int warps, int splits, cudaStream_t stream) {
  const size_t smem = attend_f32_smem_bytes(KC, HD, warps);
  cudaError_t e = allow_smem(window_attention_f32_kernel<HD, KC>, smem);
  if (e != cudaSuccess) return e;
  const int rows = kF32RowsWarp * warps;
  dim3 grid((a.N + rows - 1) / rows, a.nW * a.h, splits);
  window_attention_f32_kernel<HD, KC><<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Args& a, int warps, int splits, cudaStream_t s) {
  switch (f32_key_chunks(a.N)) {
    case 2: return launch_kc<HD, 2>(a, warps, splits, s);
    case 5: return launch_kc<HD, 5>(a, warps, splits, s);
    case 8: return launch_kc<HD, 8>(a, warps, splits, s);
    default: return launch_kc<HD, 11>(a, warps, splits, s);
  }
}

template <int HD>
int blocks(int N, int warps) {
  const size_t smem = attend_f32_smem_bytes(f32_key_chunks(N), HD, warps);
  switch (f32_key_chunks(N)) {
    case 2: return blocks_per_sm(window_attention_f32_kernel<HD, 2>, 32 * warps, smem);
    case 5: return blocks_per_sm(window_attention_f32_kernel<HD, 5>, 32 * warps, smem);
    case 8: return blocks_per_sm(window_attention_f32_kernel<HD, 8>, 32 * warps, smem);
    default: return blocks_per_sm(window_attention_f32_kernel<HD, 11>, 32 * warps, smem);
  }
}

}  // namespace

extern "C" {

// Shared memory of a block of `warps` warps at N, hd, and the blocks an
// SM holds (registers included); -1 where hd is not built.
long long fiber_window_attention_f32_smem_bytes(int N, int hd, int warps) {
  return f32_takes(N, hd)
      ? (long long)attend_f32_smem_bytes(f32_key_chunks(N), hd, warps) : -1;
}

int fiber_window_attention_f32_blocks_per_sm(int N, int hd, int warps) {
  switch (hd) {
    case 8: return blocks<8>(N, warps);
    case 16: return blocks<16>(N, warps);
    case 32: return blocks<32>(N, warps);
    case 64: return blocks<64>(N, warps);
    default: return -1;
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// qkv (B, nW, N, 3 h hd) and out (B, nW, N, h hd) contiguous fp32, 16-byte
// aligned; bias fp32, element (w, head, i, j) at w * bias_w_stride +
// (head * N + i) * N + j; `warps` (8 query rows each) a block, `splits` of
// the batch.
int fiber_window_attention_f32_fwd(const void* qkv, const void* bias,
                                   void* out, int B, int nW, int N, int h,
                                   int hd, long long bias_w_stride,
                                   float scale, int warps, int splits,
                                   void* stream) {
  if (!f32_takes(N, hd) || warps < 1 || warps > kF32FwdMaxWarps
      || splits < 1 || splits > B)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(qkv), static_cast<const float*>(bias),
               static_cast<float*>(out), B, nW, N, h, bias_w_stride, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return (int)launch<8>(a, warps, splits, s);
    case 16: return (int)launch<16>(a, warps, splits, s);
    case 32: return (int)launch<32>(a, warps, splits, s);
    case 64: return (int)launch<64>(a, warps, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
