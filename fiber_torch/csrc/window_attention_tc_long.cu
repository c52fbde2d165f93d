// Windowed multi-head attention forward for Hopper (sm_90a), bf16, on the
// tensor cores, for windows of 144 < N <= 352 tokens: FIBER's 18 x 18
// windows (N = 324) at 576^2, where every window attention of Swin-B runs
// at N = 324, hd = 32.  (N <= 144 runs window_attention_tc.cu, fp32 and
// hd = 128 window_attention.cu on the CUDA cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas
// (body _packed_kernel) at those window sizes.  For every (batch, window,
// head)
//
//     out = softmax(round(q * hd^-1/2) . k^T + bias[window, head]) . v
//
// with q, k, v read straight out of the packed (B, nW, N, 3C) qkv rows, the
// bias (nW, h, N, N) fp32 shared over the batch (its window axis may have a
// stride of 0) and the output written as (B, nW, N, C) bf16, with the
// rounding steps of the plain version window_attention_reference
// (fiber_torch/ops/window_attention.py): q scaled in fp32 and rounded to
// bf16, fp32 logits on top of the fp32 bias, an fp32 softmax, the
// probabilities normalised and then rounded to bf16, P.V accumulated in
// fp32 and rounded on store.  The two-pass routine is
// window_attention_tc_long.cuh's, shared with K2's long-window backward.
//
// The grid is (ceil(N / R), nW * h, S): block (r, w * h + head, s) owns
// query rows [r R, r R + R) of one (window, head) and walks the batch
// elements of split s in ascending order.  The row blocks of one (window,
// head) are neighbours in the launch order, so they run at about the same
// time and read its K and V from device memory once, then from L2.  It stages its R bias rows once
// (R x (NP + 8) fp32) and, for each element, all keys of K and V and its q
// rows, double-buffered: the next element's are copied by cp.async while
// the current one is computed, so a copy has a whole element's work to
// land in.  Each 16-row slab runs on P warps (P "parts"): part p walks its
// share of the key tiles (NP / 8 tiles cut into P runs of tile pairs) in
// steps of up to 8 tiles, through both passes.  After pass 1 the parts
// trade their rows' (max, sum) through shared memory, and each forms the
// row's M and L from them in the order p = 0 ... P - 1 (the same bits in
// every part); after pass 2, part 0 adds the other parts' fp32 P.V
// accumulators in that order and stores.  R, P and S come from the
// wrapper's pure plan (_long_plan).  Every output element is written by
// one thread: no atomics, and two calls give the same bits.
//
// What bounds it on the card: bytes.  At stage 1 of 576^2 at B = 4 (nW =
// 64, h = 4, shifted) the fp32 bias is 107.5 MB and qkv with the output
// 85 MB, 0.057 ms at 3.35 TB/s; the products are 13.8 GFLOP (0.014 ms at
// 989 TFLOP/s; 20.6 GFLOP as run, QK^T twice).  What held the first version
// of this kernel (P = 1, R = 64: 205,824 bytes of shared memory, one 4-warp
// block an SM, 0.3952 ms there on an H100) was the latency of each warp's
// dependent mma.sync, ldmatrix and exp steps, one warp per scheduler.  The
// staged bias and keys fill the SM's shared memory whatever the warps, so
// this version puts more warps on the same rows: P = 2-4 gives 8-16 warps
// an SM.  (Streaming K and V, or the bias too, through a ring of 64-key
// blocks, to fit more blocks an SM, was slower here: a ring prefetches one
// step ahead, too little to hide a copy's latency, and a streamed bias is
// read from device memory twice per batch element.)
// Limits: N <= 352, hd in {8, 16, 32, 64}, R a multiple of 16, R / 16 x P
// <= 16 warps, P <= NP / 16 (every part has a real key), within a block's
// shared memory.  The kernel's body is attend_long
// (window_attention_tc_long.cuh), which K4's long-window kernel
// (window_attention_heads_tc_long.cu) runs on per-head rows.

#include <stdint.h>

#include "window_attention_tc_long.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

template <int HD>
__global__ void __launch_bounds__(kLongMaxThreads, 1)
window_attention_fwd_tc_long_kernel(const bf16* __restrict__ qkv,
                                    const float* __restrict__ bias,
                                    bf16* __restrict__ out, int B, int nW, int N,
                                    int h, long long bias_w_stride, float scale,
                                    int parts) {
  const int w = blockIdx.y / h;
  const int head = blockIdx.y - w * h;
  const int C = h * HD;
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);
  extern __shared__ __align__(16) unsigned char smem[];

  const size_t row0 = (size_t)w * N;  // window w's first token, element 0
  const PackedRows rows{qkv + row0 * 3 * C + head * HD,
                        out + row0 * C + head * HD,
                        (long long)nW * N * 3 * C, (long long)nW * N * C,
                        3LL * C, (long long)C, C};
  attend_long<HD>(rows, bias + (size_t)w * bias_w_stride + (size_t)head * N * N,
                  N, b_begin, b_end, scale, parts, smem);
}

template <int HD>
cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int nW,
                   int N, int h, long long bias_w_stride, float scale, int R,
                   int parts, int splits, cudaStream_t stream) {
  auto kernel = window_attention_fwd_tc_long_kernel<HD>;
  const size_t smem = FwdLongLayout(N, HD, R, parts).total();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((N + R - 1) / R, nW * h, splits), R / 16 * parts * 32, smem,
           stream>>>(static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
                     static_cast<bf16*>(out), B, nW, N, h, bias_w_stride, scale,
                     parts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of R query rows on `parts` warps a slab needs;
// -1 where the shape is not taken.
long long fiber_window_attention_tc_long_smem_bytes(int N, int hd, int R,
                                                    int parts) {
  return long_takes(N, hd, R, parts)
      ? (long long)FwdLongLayout(N, hd, R, parts).total() : -1;
}

// Resident blocks per SM; -1 on error or where the shape is not taken.
int fiber_window_attention_tc_long_blocks_per_sm(int N, int hd, int R,
                                                 int parts) {
  if (!long_takes(N, hd, R, parts)) return -1;
  const size_t smem = FwdLongLayout(N, hd, R, parts).total();
  const int threads = R / 16 * parts * 32;
  switch (hd) {
    case 8: return blocks_per_sm(window_attention_fwd_tc_long_kernel<8>, threads, smem);
    case 16: return blocks_per_sm(window_attention_fwd_tc_long_kernel<16>, threads, smem);
    case 32: return blocks_per_sm(window_attention_fwd_tc_long_kernel<32>, threads, smem);
    default: return blocks_per_sm(window_attention_fwd_tc_long_kernel<64>, threads, smem);
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// qkv (B, nW, N, 3 h hd) and out (B, nW, N, h hd) contiguous bf16, 16-byte
// aligned; bias fp32, element (w, head, i, j) at w * bias_w_stride +
// (head * N + i) * N + j, 16-byte aligned; R query rows a block (a multiple
// of 16) on `parts` warps a 16-row slab; 1 <= splits <= B.
int fiber_window_attention_tc_long_fwd(const void* qkv, const void* bias,
                                       void* out, int B, int nW, int N, int h,
                                       int hd, long long bias_w_stride,
                                       float scale, int R, int parts,
                                       int splits, void* stream) {
  if (!long_takes(N, hd, R, parts) || splits < 1 || splits > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return (int)launch<8>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
    case 16: return (int)launch<16>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
    case 32: return (int)launch<32>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
    default: return (int)launch<64>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, parts, splits, s);
  }
}

}  // extern "C"
