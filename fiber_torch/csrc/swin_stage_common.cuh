// Pieces shared by the two fused-Swin-blocks kernels (K3): swin_stage.cu
// (CUDA cores, fp32 and bf16) and swin_stage_tc.cu (tensor cores, bf16):
// the kernel parameters, the row-to-token map of the rolled windows, the
// GEMM epilogues and the GELU's erf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fiber {

struct Params {
  const void* x;
  void* act;     // the output, which holds the activations between blocks
  void* qkv;     // (B, nW, N, 3C) scratch, window order
  void* ctx;     // (B, nW, N, C) scratch, window order
  void* hid;     // (B, H, W, hidden) scratch
  const float* ln1_s;
  const float* ln1_b;
  const void* qkv_w;
  const void* qkv_b;
  const void* proj_w;
  const void* proj_b;
  const float* ln2_s;
  const float* ln2_b;
  const void* fc1_w;
  const void* fc1_b;
  const void* fc2_w;
  const void* fc2_b;
  const float* rpb;   // (n, h, N, N)
  const float* mask;  // (nW, N, N), read on shifted blocks only
  int n_blocks, B, H, W, C, hidden, window, heads, use_shift;
  float scale;
};

// Row r of the (B, nW, N) window order over the (B, H, W) token grid rolled
// by -shift on both axes -> the token it holds.  win == 0: token r.
struct Rows {
  int H, W, win, shift;
  __device__ __forceinline__ long long token(long long r) const {
    if (win == 0) return r;
    const int N = win * win;
    const int nWw = W / win;
    const int nW = (H / win) * nWw;
    const int n = (int)(r % N);
    const long long bw = r / N;
    const int w = (int)(bw % nW);
    const long long b = bw / nW;
    int i = (w / nWw) * win + n / win + shift;
    int j = (w % nWw) * win + n % win + shift;
    if (i >= H) i -= H;
    if (j >= W) j -= W;
    return (b * H + i) * W + j;
  }
};

enum Epilogue {
  kBias = 0,           // o = round(acc + bias)
  kBiasResidRound = 1, // o = round(o + round(acc + bias))
  kBiasGelu = 2,       // o = round(gelu(acc + bias))
  kBiasResid = 3,      // o = round(o + (acc + bias))
};

// erf by Abramowitz-Stegun 7.1.26, as the TPU kernel computes it
__device__ __forceinline__ float erf_as(float x) {
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.0f - poly * expf(-ax * ax));
}

// gelu(v) with erf_as, in fp32
__device__ __forceinline__ float gelu_as(float v) {
  return 0.5f * v * (1.0f + erf_as(v * 0.70710678118654752f));
}

}  // namespace fiber
