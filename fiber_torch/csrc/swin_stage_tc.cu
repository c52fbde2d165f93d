// A run of n unfused Swin blocks in one launch (inference), bf16, on the
// H100's tensor cores (sm_90a: warp-level mma.sync m16n8k16, bf16
// operands, fp32 accumulators, fed by ldmatrix and cp.async).  (bf16 at
// 144 < N <= 352 runs swin_stage_tc_long.cu, the same phases with the
// long-window attention; fp32, and bf16 at hd = 128, run swin_stage.cu on
// the CUDA cores.)  The GEMM and LayerNorm phases, the run of blocks and
// the cooperative launch are in swin_stage_tc.cuh, shared with the
// long-window kernel.
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/swin_stage.py::fused_swin_blocks (body _kernel).  It
// computes swin_stage.cu's function (see there) with the rounding points of
// the plain version fiber_torch/ops/swin_stage.py::
// fused_swin_blocks_reference: LayerNorm in fp32 rounded to bf16 before its
// product; every product accumulating in fp32 with its bias, GELU and
// residual epilogues in fp32; qkv, the probabilities, the context and the
// projection rounded to bf16; the logits the fp32 q . k^T scaled by
// hd^-1/2 after the product, plus (rpb + mask) summed once in fp32 as the
// tile is staged (the plain version adds rpb, then the mask: at most one
// fp32 ulp apart).
//
// What bounds it on the card: operations.  At FIBER-Base 384^2 stage 3
// (C = 512, N = 144, the 14 trunk blocks at B = 4) the products are about
// 212 GFLOP, 203 of them the four GEMMs (24 C^2 FLOP a token), on 88 MB of
// bf16 weights: 0.21 ms at 989 TFLOP/s.  The first K3 (swin_stage.cu) ran
// every product in fp32 on the CUDA cores and took 24 ms there.  Here:
// * the same persistent cooperative launch: grid = resident blocks per SM
//   x SMs (the wrapper computes it, a grid that does not fit is refused),
//   grid syncs between the phases, and the rolled windows read and written
//   through one row-to-token map (Rows, swin_stage_common.cuh), with no
//   roll kernel;
// * seven phases per Swin block: LN1 -> qkv -> attention -> proj -> LN2 ->
//   fc1 -> fc2.  LayerNorm is a phase of its own, one warp a row: its fp32
//   statistics are computed once per row (the first K3 recomputed them for
//   every column tile of qkv and fc1, 24 and 32 times at stage 3) and the
//   rounded rows are written in the order the next product reads them
//   (LN1 in window order, LN2 in token order), into the context buffer,
//   which is free at both points;
// * one GEMM routine, BM x BN output tiles over a kStages-deep cp.async
//   pipeline of 32-deep slabs in 16-byte-padded rows (conflict-free
//   ldmatrix), 8 warps each on a (BM / WM) x (BN / WN) warp tile of
//   mma.sync; A's rows through per-row offsets (gathered, rolled rows
//   work), W in nn.Linear's (out, in) layout as the "col" operand, with no
//   transpose; the epilogues on the accumulator fragments in fp32, each
//   output pair written by one thread as bf16x2;
// * the tile shape of each product (128x128, 128x64 or 64x64) chosen on
//   the host by a cost model over the launched grid, waves x shared-memory
//   traffic per tile (fiber_torch/ops/swin_stage.py::_k3_plan), and passed
//   in the parameters;
// * attention items (window, head, split): the split walks batch elements
//   as K1 does, staging the bias tile once per item (attend_heads_tc of
//   window_attention_tc.cuh, scale after the product, its slabs looped
//   over the block's warps); the wrapper picks the split with K1's
//   _bwd_splits on K3's grid.
// Every output element is written by one thread, without atomics: two
// calls give the same bits.
//
// Shared memory: the larger of the GEMM pipeline's (83,968 bytes) and
// attend_tc_smem_bytes(N, hd) (156,672 at N = 144, hd = 32): one block of
// 9 warps per SM there.  Left for later: wgmma + TMA (the only way to the
// card's full tensor-core rate) and keeping fc1's hidden tile on chip for
// fc2.
//
// Limits: bf16, N <= 144 and hd in {8, 16, 32, 64} (attend_heads_tc's),
// C and the MLP width multiples of 32, H and W multiples of the window;
// every tensor 16-byte aligned (the wrapper checks and raises).

#include <stdint.h>

#include "swin_stage_tc.cuh"

namespace {

using namespace fiber;
using namespace fiber::swin_tc;

constexpr int kThreads = kTcMaxWarps * 32;  // 9 warps: a slab each at N = 144

__host__ __device__ inline size_t smem_bytes(int N, int hd) {
  const size_t a = attend_tc_smem_bytes(N, hd);
  return a > kGemmSmem ? a : kGemmSmem;
}

// The attention of Swin block j: items (window, head, split) over the
// grid, each running attend_heads_tc over its split's batch elements.
template <int HD>
__device__ __noinline__ void attention_phase(const Params p, int splits, int j,
                                             bool shifted, unsigned char* smem) {
  const int C = p.C, h = p.heads, N = p.window * p.window;
  const int nW = (p.H / p.window) * (p.W / p.window);
  const int units = nW * h;
  const bf16* qkv = static_cast<const bf16*>(p.qkv);
  bf16* ctx = static_cast<bf16*>(p.ctx);
  for (int it = blockIdx.x; it < units * splits; it += gridDim.x) {
    const int s = it / units, wh = it - s * units;
    const int w = wh / h, head = wh - w * h;
    int b0, b1;
    split_range(p.B, splits, s, &b0, &b1);
    const size_t row0 = (size_t)w * N;  // window w's first token, element 0
    const PackedRows rows{qkv + row0 * 3 * C + head * HD, ctx + row0 * C + head * HD,
                          (long long)nW * N * 3 * C, (long long)nW * N * C,
                          3LL * C, (long long)C, C};
    attend_heads_tc<HD, true, true>(
        rows, p.rpb + ((size_t)j * h + head) * N * N, N, b0, b1, p.scale, smem,
        shifted ? p.mask + (size_t)w * N * N : nullptr);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_swin_blocks_tc_kernel(const Params p, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  swin_blocks(p, plan, smem, [&](int j, bool shifted) {
    switch (p.C / p.heads) {
      case 8: attention_phase<8>(p, plan.splits, j, shifted, smem); break;
      case 16: attention_phase<16>(p, plan.splits, j, shifted, smem); break;
      case 32: attention_phase<32>(p, plan.splits, j, shifted, smem); break;
      default: attention_phase<64>(p, plan.splits, j, shifted, smem); break;
    }
  });
}

cudaError_t launch(const Params& p, const Plan& plan, int grid,
                   cudaStream_t stream) {
  Params args = p;
  Plan plan_args = plan;
  void* kargs[] = {&args, &plan_args};
  return launch_cooperative(fused_swin_blocks_tc_kernel, grid, kThreads,
                            smem_bytes(p.window * p.window, p.C / p.heads),
                            kargs, stream);
}

}  // namespace

extern "C" {

// Shared memory one block needs; -1 where the shape is not taken.
long long fiber_fused_swin_blocks_tc_smem_bytes(int N, int hd) {
  return attend_tc_takes(N, hd) ? (long long)smem_bytes(N, hd) : -1;
}

// Resident blocks per SM; -1 on error or where the shape is not taken.
int fiber_fused_swin_blocks_tc_blocks_per_sm(int N, int hd) {
  if (!attend_tc_takes(N, hd)) return -1;
  return blocks_per_sm(fused_swin_blocks_tc_kernel, kThreads, smem_bytes(N, hd));
}

// Runs n_blocks Swin blocks over x (B, H, W, C) into out, in one
// cooperative launch of `grid` blocks on `stream`; returns a CUDA error
// code (0 on success).  Activations, scratch and weights are contiguous
// bf16 (weights stacked over the blocks in nn.Linear's (out, in) layout);
// LayerNorm parameters, rpb (n, h, N, N) and mask (nW, N, N) fp32; every
// pointer 16-byte aligned.  `splits` (1 <= splits <= B) splits the batch of
// the attention items; tile_* index kTiles for the four products.  A grid
// larger than the card holds at once is refused with
// cudaErrorCooperativeLaunchTooLarge.
int fiber_fused_swin_blocks_tc(
    const void* x, void* out, void* qkv, void* ctx, void* hid,
    const void* ln1_s, const void* ln1_b, const void* qkv_w, const void* qkv_b,
    const void* proj_w, const void* proj_b, const void* ln2_s,
    const void* ln2_b, const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* rpb, const void* mask, int n_blocks, int B,
    int H, int W, int C, int hidden, int window, int heads, int use_shift,
    float scale, int grid, int splits, int tile_qkv, int tile_proj,
    int tile_fc1, int tile_fc2, void* stream) {
  const Plan plan{splits, {tile_qkv, tile_proj, tile_fc1, tile_fc2}};
  const Params p{x, out, qkv, ctx, hid,
                 static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
                 qkv_w, qkv_b, proj_w, proj_b,
                 static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
                 fc1_w, fc1_b, fc2_w, fc2_b,
                 static_cast<const float*>(rpb), static_cast<const float*>(mask),
                 n_blocks, B, H, W, C, hidden, window, heads, use_shift, scale};
  if (!stack_takes(p, plan) || !attend_tc_takes(window * window, C / heads))
    return (int)cudaErrorInvalidValue;
  return (int)launch(p, plan, grid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
