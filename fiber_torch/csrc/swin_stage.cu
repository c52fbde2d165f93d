// A run of n unfused Swin blocks in one launch (inference), for Hopper
// (sm_90a), on the CUDA cores, at hd = 128 in fp32 and bf16: the head dim
// the tensor-core routes do not take, and that no model runs.  (At hd <= 64
// bf16 runs swin_stage_tc.cu up to N = 144 and swin_stage_tc_long.cu
// beyond, fp32 swin_stage_tf32.cu; this source builds no instance for
// them.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/swin_stage.py::fused_swin_blocks (body _kernel).  Block j of
// the stack maps the (B, H, W, C) activations x to
//
//     a = roll(x, -w/2) if j is odd and use_shift else x
//     a = a + round(proj(attn(round(qkv(round(LN1(a)))))))      (per window)
//     a = round(a + fc2(round(gelu(fc1(round(LN2(a)))))))
//     x = roll(a, +w/2) if shifted else a
//
// with the rounding points of the plain PyTorch version
// (fiber_torch/ops/swin_stage.py::fused_swin_blocks_reference), which are
// the TPU kernel's: LayerNorm in fp32 (eps 1e-5) rounded to the activation
// type T; every product accumulates in fp32 and gets its bias in fp32; qkv,
// the probabilities, the attention context and the projection are rounded
// to T; the attention logits are the fp32 product scaled by hd^-1/2 after
// it, plus the fp32 relative-position bias and, on shifted blocks, the
// fp32 shift mask; the GELU is erf's with the Abramowitz-Stegun 7.1.26
// polynomial for erf (|error| <= 1.5e-7), in fp32; the residual sums are
// fp32, rounded to T.  Weights are in nn.Linear's (out, in) layout, in T;
// LayerNorm parameters and the bias tables are fp32.
//
// What bounds it on the card: operations.  At FIBER-Base 384^2 stage 3
// (C = 512, N = 144) a block does 24 C^2 + 4 N C FLOP per token on 12 C^2
// weights that every token shares, so weights are read once per tile and the
// products dominate (about 213 GFLOP for the 14 trunk blocks at B = 4,
// against about 88 MB of bf16 weights).  This first design runs them on the
// CUDA cores in fp32 (67 TFLOP/s at most on an H100) and does nothing yet
// about the tensor cores; what it does is the TPU kernel's point, one launch
// for the whole run:
//
// - a persistent grid launched with cudaLaunchCooperativeKernel, sized by
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor so that every block is
//   co-resident (a larger grid is refused, never shrunk), with
//   cooperative_groups grid syncs between the phases;
// - five phases per Swin block, each a loop over work items: (a) LN1 + the
//   qkv product over 64 x 64 output tiles, its rows read at the rolled,
//   window-partitioned token coordinates by index arithmetic (no physical
//   roll); (b) attention per (b, window, head), the routine of K1
//   (window_attention_common.cuh) with the scale after the product;
//   (c) proj + bias + residual, written back at the un-rolled coordinates;
//   (d) LN2 + fc1 + GELU; (e) fc2 + bias + residual;
// - one GEMM tile routine for (a), (c), (d) and (e), with an optional
//   LayerNorm prologue (row statistics per tile) and the epilogues above;
// - the activations (the output buffer) and the qkv, context and hidden
//   scratch in device memory, allocated by the wrapper; at stage 3 and
//   B = 4 the activations are 2.4 MB in bf16 and stay in the 50 MB L2.
//
// The designs on the tensor cores are swin_stage_tc.cu (bf16) and
// swin_stage_tf32.cu (fp32, split-TF32 products).
//
// Limits: hd = 128 in fp32 or bf16,
// window N <= 352 tokens, C and the MLP width multiples of 32, H and W
// multiples of the window, the attention staging within a block's shared
// memory (the wrapper checks and raises: fp32 at N = 324 and hd = 128 does
// not fit).  N <= 256 runs
// attend_head with 8 key chunks a lane; 256 < N <= 352 (FIBER's 18 x 18
// windows at 576^2) a second instance with 11, as K1 does.  The grid is
// sized from the occupancy the card reports for the instance it launches,
// never larger; fiber_fused_swin_blocks_attrs reports each instance's
// registers, local bytes and blocks an SM (on an H100 the fp32 instances
// at hd = 32, before they moved to swin_stage_tf32.cu, took 128 registers,
// the cap of __launch_bounds__(256, 2), with no spills, and 2 blocks an SM
// at N = 324).

#include <cooperative_groups.h>
#include <stdint.h>

#include "swin_stage_common.cuh"
#include "window_attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fiber;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // output tile: kTile rows x kTile columns
constexpr int kSlab = 32;           // reduction depth staged per step
constexpr int kLd = kTile + 1;      // odd row stride of the staged slabs
// two fp32 slabs, LayerNorm mean and 1/std per row, A and output row offsets
constexpr size_t kGemmSmem = 2 * sizeof(float) * kSlab * kLd
                           + 2 * sizeof(float) * kTile
                           + 2 * sizeof(long long) * kTile;

template <typename T>
__host__ __device__ inline size_t smem_bytes(int N, int hd) {
  const size_t a = attend_smem_bytes<T>(N, hd, kWarps);
  return a > kGemmSmem ? a : kGemmSmem;
}

// One kTile x kTile tile (rows tm, columns tn) of
//     O[orows(r), c] = epilogue(sum_k A'[r, k] * Wt[c, k] + bias[c])
// where row r of A is at A + arows(r) * lda and, with LN, A' is its
// LayerNorm (fp32 statistics, eps 1e-5) times ln_s plus ln_b, rounded to T.
// 256 threads, each 4 x 4 outputs (rows ty + 16 i, columns tx + 16 j).
template <typename T, int EPI, bool LN>
__device__ void gemm_tile(int tm, int tn, long long M, int K, int Nout,
                          const T* __restrict__ A, int lda, Rows arows,
                          const T* __restrict__ Wt, const T* __restrict__ bias,
                          T* O, int ldo, Rows orows,
                          const float* __restrict__ ln_s,
                          const float* __restrict__ ln_b,
                          unsigned char* smem) {
  float* As = reinterpret_cast<float*>(smem);   // [kSlab][kLd]
  float* Bs = As + kSlab * kLd;                 // [kSlab][kLd]
  float* mu = Bs + kSlab * kLd;                 // [kTile]
  float* rstd = mu + kTile;                     // [kTile]
  long long* aoff = reinterpret_cast<long long*>(rstd + kTile);
  long long* ooff = aoff + kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long r0 = (long long)tm * kTile;
  const int c0 = tn * kTile;

  __syncthreads();  // the last users of this shared memory are done
  if (tid < kTile) {
    const long long r = r0 + tid;
    aoff[tid] = r < M ? arows.token(r) * lda : -1;
    ooff[tid] = r < M ? orows.token(r) * ldo : -1;
  }
  __syncthreads();
  if (LN) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int rr = warp; rr < kTile; rr += kWarps) {
      float m = 0.f, rs = 0.f;
      if (aoff[rr] >= 0) {
        const T* a = A + aoff[rr];
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += to_float(a[k]);
        m = warp_sum(s) / K;
        float s2 = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = to_float(a[k]) - m;
          s2 += d * d;
        }
        rs = rsqrtf(warp_sum(s2) / K + 1e-5f);
      }
      if (lane == 0) {
        mu[rr] = m;
        rstd[rr] = rs;
      }
    }
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSlab) {
    // a warp reads 32 consecutive k of one row of A and of one row of Wt
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int rr = e / kSlab, kk = e - rr * kSlab;
      float a = 0.f;
      if (aoff[rr] >= 0) {
        a = to_float(A[aoff[rr] + k0 + kk]);
        if (LN)
          a = round_to<T>((a - mu[rr]) * rstd[rr] * ln_s[k0 + kk] + ln_b[k0 + kk]);
      }
      As[kk * kLd + rr] = a;
      const int c = c0 + rr;
      Bs[kk * kLd + rr] = c < Nout ? to_float(Wt[(size_t)c * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSlab; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = ooff[ty + 16 * i];
    if (off < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= Nout) continue;
      T* o = O + off + c;
      float v = acc[i][j] + to_float(bias[c]);
      if (EPI == kBiasGelu) v = gelu_as(v);
      if (EPI == kBiasResidRound) v = to_float(*o) + round_to<T>(v);
      if (EPI == kBiasResid) v = to_float(*o) + v;
      *o = from_float<T>(v);
    }
  }
}

// Every output tile of one product, spread over the grid.
template <typename T, int EPI, bool LN>
__device__ void gemm_phase(long long M, int K, int Nout, const T* A, int lda,
                           Rows arows, const T* Wt, const T* bias, T* O,
                           int ldo, Rows orows, const float* ln_s,
                           const float* ln_b, unsigned char* smem) {
  const int tiles_m = (int)((M + kTile - 1) / kTile);
  const int tiles = tiles_m * ((Nout + kTile - 1) / kTile);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gemm_tile<T, EPI, LN>(t % tiles_m, t / tiles_m, M, K, Nout, A, lda, arows,
                          Wt, bias, O, ldo, orows, ln_s, ln_b, smem);
}

// Phase (b): the attention of every (b, window, head), spread over the grid.
template <typename T, int HD, bool MASK, int KC>
__device__ void attention_phase(const Params& p, int j, unsigned char* smem) {
  const int C = p.C, h = p.heads, N = p.window * p.window;
  const int nW = (p.H / p.window) * (p.W / p.window);
  const T* qkv = static_cast<const T*>(p.qkv);
  T* ctx = static_cast<T*>(p.ctx);
  const int items = p.B * nW * h;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int head = it % h;
    const int bw = it / h;
    const int w = bw % nW;
    const size_t row0 = (size_t)bw * N;
    const T* q = qkv + row0 * 3 * C + head * HD;
    attend_head<T, HD, true, MASK, KC>(
        q, q + C, q + 2 * C, 3 * C, ctx + row0 * C + head * HD, C,
        p.rpb + ((size_t)j * h + head) * N * N,
        MASK ? p.mask + (size_t)w * N * N : nullptr, N, p.scale, smem, kWarps);
    __syncthreads();  // before the next item stages K and V
  }
}

template <typename T, int HD, int KC>
__global__ void __launch_bounds__(kThreads, 2)
fused_swin_blocks_kernel(const Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, hid = p.hidden;
  const long long M = (long long)p.B * p.H * p.W;
  const T* x = static_cast<const T*>(p.x);
  T* act = static_cast<T*>(p.act);
  T* qkv = static_cast<T*>(p.qkv);
  T* ctx = static_cast<T*>(p.ctx);
  T* hbuf = static_cast<T*>(p.hid);
  const T* qkv_w = static_cast<const T*>(p.qkv_w);
  const T* qkv_b = static_cast<const T*>(p.qkv_b);
  const T* proj_w = static_cast<const T*>(p.proj_w);
  const T* proj_b = static_cast<const T*>(p.proj_b);
  const T* fc1_w = static_cast<const T*>(p.fc1_w);
  const T* fc1_b = static_cast<const T*>(p.fc1_b);
  const T* fc2_w = static_cast<const T*>(p.fc2_w);
  const T* fc2_b = static_cast<const T*>(p.fc2_b);

  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < M * C;
       i += (long long)gridDim.x * kThreads)
    act[i] = x[i];
  grid.sync();

  const Rows lin{p.H, p.W, 0, 0};
  for (int j = 0; j < p.n_blocks; ++j) {
    const bool shifted = p.use_shift && (j & 1);
    const Rows win{p.H, p.W, p.window, shifted ? p.window / 2 : 0};
    // (a) LN1 + qkv, rows in window order
    gemm_phase<T, kBias, true>(M, C, 3 * C, act, C, win,
                               qkv_w + (size_t)j * 3 * C * C,
                               qkv_b + (size_t)j * 3 * C, qkv, 3 * C, lin,
                               p.ln1_s + (size_t)j * C, p.ln1_b + (size_t)j * C,
                               smem);
    grid.sync();
    // (b) window attention
    if (shifted)
      attention_phase<T, HD, true, KC>(p, j, smem);
    else
      attention_phase<T, HD, false, KC>(p, j, smem);
    grid.sync();
    // (c) proj + residual, back to the token grid
    gemm_phase<T, kBiasResidRound, false>(M, C, C, ctx, C, lin,
                                          proj_w + (size_t)j * C * C,
                                          proj_b + (size_t)j * C, act, C, win,
                                          nullptr, nullptr, smem);
    grid.sync();
    // (d) LN2 + fc1 + GELU
    gemm_phase<T, kBiasGelu, true>(M, C, hid, act, C, lin,
                                   fc1_w + (size_t)j * hid * C,
                                   fc1_b + (size_t)j * hid, hbuf, hid, lin,
                                   p.ln2_s + (size_t)j * C,
                                   p.ln2_b + (size_t)j * C, smem);
    grid.sync();
    // (e) fc2 + residual
    gemm_phase<T, kBiasResid, false>(M, hid, C, hbuf, hid, lin,
                                     fc2_w + (size_t)j * C * hid,
                                     fc2_b + (size_t)j * C, act, C, lin,
                                     nullptr, nullptr, smem);
    grid.sync();
  }
}

// The instance of the kernel that a window of N tokens runs.
template <typename T, int HD>
const void* kernel_for(int N) {
  return N <= 32 * kMaxKeyChunks
      ? reinterpret_cast<const void*>(fused_swin_blocks_kernel<T, HD, kMaxKeyChunks>)
      : reinterpret_cast<const void*>(fused_swin_blocks_kernel<T, HD, kLongKeyChunks>);
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream, int* grid_out) {
  const void* kernel = kernel_for<T, HD>(p.window * p.window);
  const size_t smem = smem_bytes<T>(p.window * p.window, HD);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  // one block per resident slot: every block must be resident for the
  // grid syncs, so a kernel that does not fit on an SM is refused
  const int grid = per_sm * sms;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid_out = grid;
  Params args = p;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), kargs,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Registers a thread, local (spilled) bytes a thread and resident blocks an
// SM of the instance a window of N tokens runs, at its shared memory.
template <typename T, int HD>
cudaError_t attrs(int N, int* out) {
  const void* kernel = kernel_for<T, HD>(N);
  const size_t smem = smem_bytes<T>(N, HD);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  if ((e = cudaFuncGetAttributes(&a, kernel)) != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                       kThreads, smem);
}

// built at hd = 128 only: the tensor-core kernels take hd <= 64
template <typename T>
cudaError_t dispatch_attrs(int N, int hd, int* out) {
  return hd == 128 ? attrs<T, 128>(N, out) : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t s,
                        int* grid_out) {
  return hd == 128 ? launch<T, 128>(p, s, grid_out) : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = fp32, 1 = bf16.
long long fiber_fused_swin_blocks_smem_bytes(int N, int hd, int dtype) {
  return (long long)(dtype == 0 ? smem_bytes<float>(N, hd)
                                : smem_bytes<__nv_bfloat16>(N, hd));
}

// out[0..2] = registers a thread, local bytes a thread and blocks an SM of
// the kernel a window of N tokens at head dim hd runs; a CUDA error code.
int fiber_fused_swin_blocks_attrs(int N, int hd, int dtype, int* out) {
  if (N < 1 || N > 32 * kLongKeyChunks) return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? dispatch_attrs<float>(N, hd, out)
                          : dispatch_attrs<__nv_bfloat16>(N, hd, out));
}

// Runs n_blocks Swin blocks over x (B, H, W, C) into out, in one
// cooperative launch on `stream`; returns a CUDA error code (0 on success)
// and the grid it launched in *grid_out.  Activations, scratch and weights
// are contiguous in `dtype` (weights stacked over the blocks in nn.Linear's
// (out, in) layout); LayerNorm parameters, rpb (n, h, N, N) and mask
// (nW, N, N) fp32.  The grid holds one block per resident slot; a kernel
// that fits no block on an SM is refused with
// cudaErrorCooperativeLaunchTooLarge.
int fiber_fused_swin_blocks(
    const void* x, void* out, void* qkv, void* ctx, void* hid,
    const void* ln1_s, const void* ln1_b, const void* qkv_w, const void* qkv_b,
    const void* proj_w, const void* proj_b, const void* ln2_s,
    const void* ln2_b, const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* rpb, const void* mask, int n_blocks, int B,
    int H, int W, int C, int hidden, int window, int heads, int use_shift,
    float scale, int dtype, void* stream, int* grid_out) {
  if (window < 1 || window * window > 32 * kLongKeyChunks || H % window ||
      W % window || C % 32 || hidden % 32 || heads < 1 || C % heads ||
      n_blocks < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  Params p{x, out, qkv, ctx, hid,
           static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
           qkv_w, qkv_b, proj_w, proj_b,
           static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
           fc1_w, fc1_b, fc2_w, fc2_b,
           static_cast<const float*>(rpb), static_cast<const float*>(mask),
           n_blocks, B, H, W, C, hidden, window, heads, use_shift, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = C / heads;
  cudaError_t e = dtype == 0
      ? dispatch_hd<float>(p, hd, s, grid_out)
      : dispatch_hd<__nv_bfloat16>(p, hd, s, grid_out);
  return (int)e;
}

}  // extern "C"
