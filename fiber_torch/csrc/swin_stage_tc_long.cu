// A run of n unfused Swin blocks in one launch (inference), bf16, on the
// H100's tensor cores, for windows of 144 < N <= 352 tokens: FIBER's
// 18 x 18 windows at 576^2 (N = 324, hd = 32 at every stage).  (N <= 144
// runs swin_stage_tc.cu; fp32, and bf16 at hd = 128, swin_stage.cu on the
// CUDA cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/swin_stage.py::fused_swin_blocks (body _kernel) at those
// window sizes.  It computes swin_stage_tc.cu's function with its rounding
// points (those of the plain version fiber_torch/ops/swin_stage.py::
// fused_swin_blocks_reference): the same persistent cooperative grid and
// the same seven phases a Swin block (LN1 -> qkv -> attention -> proj ->
// LN2 -> fc1 -> fc2, swin_stage_tc.cuh), with the attention phase of the
// long windows.
//
// What bounds it on the card: operations.  At 576^2 stage 3 (C = 512, 16
// heads, 4 windows of N = 324) with two blocks at B = 2 the products are
// 36 GFLOP, 32.6 of them the four GEMMs (24 C^2 FLOP a token): 0.037 ms at
// 989 TFLOP/s.  Before this kernel bf16 took swin_stage.cu there, every
// product in fp32 on the CUDA cores and the attention through an 11-key-
// chunk attend_head: 4.1 ms, slower than its own plain version.
//
// The attention phase: items (row block, window, head, split), the row
// blocks of one (window, head) neighbours in the grid's order, so that
// they read its K and V from device memory about once; each item runs
// attend_long_rows (window_attention_tc_long.cuh), K1's two-pass
// tensor-core routine, with K3's rounding (the logits fp32(q . k^T) scaled
// after the product, rounded, plus the bias) and, on shifted blocks, the
// window's mask rows summed into the staged bias rows once by plain loads
// (no extra shared memory).  R query rows an item on `parts` warps a
// 16-row slab, and the batch splits, come from the wrapper's plan
// (fiber_torch/ops/swin_stage.py::_k3_plan).
//
// The block: 12 warps, one an SM (__launch_bounds__(384, 1): at most 168
// registers a thread).  The GEMMs run on 8 of them (kGemmWarps), the other
// four copy; the attention runs on R / 16 x parts <= 12.  At N = 324,
// hd = 32 (FwdLongLayout):
//   R = 48, 3 parts:  9 warps, 194,688 bytes, 7 row blocks;
//   R = 64, 2 parts:  8 warps, 215,040 bytes, 6 row blocks;
//   R = 64, 3 parts: 12 warps, 223,744 bytes, 6 row blocks.
// The last is K1's measured best on an H100 (R = 64 on 1 / 2 / 3 / 4
// parts: 0.41 / 0.34 / 0.31 / 0.34 ms at 576^2 stage 1, B = 4), and at
// stage 3, B = 2 its 384 items fill the 132 blocks in 3 waves of 2 batch
// elements, where R = 48 needs 7 waves of 1 (448 items, 2 splits) and two
// parts give each warp 1.5x the keys.  Shared memory is the larger of the
// attention's and the GEMM pipeline's (83,968 bytes); a shape that does not
// fit a block is refused, never shrunk or sent elsewhere.
// Every output element is written by one thread, without atomics: two
// calls give the same bits.
//
// Limits: bf16, N <= 352 and hd in {8, 16, 32, 64} (attend_long_rows'), R
// a multiple of 16 with R / 16 x parts <= 12 warps, within a block's shared
// memory; C and the MLP width multiples of 32, H and W multiples of the
// window; every tensor 16-byte aligned (the wrapper checks and raises).

#include <stdint.h>

#include "swin_stage_tc.cuh"
#include "window_attention_tc_long.cuh"

namespace {

using namespace fiber;
using namespace fiber::swin_tc;

constexpr int kLongWarps = 12;  // R / 16 x parts of the attention, at most
constexpr int kThreads = kLongWarps * 32;

// The attention's rows a block and warps a slab.
struct LongPlan {
  int rows, parts;
};

__host__ __device__ inline size_t smem_bytes(int N, int hd, int R, int parts) {
  const size_t a = FwdLongLayout(N, hd, R, parts).total();
  return a > kGemmSmem ? a : kGemmSmem;
}

inline bool takes(int N, int hd, int R, int parts) {
  return long_takes(N, hd, R, parts) && R / 16 * parts <= kLongWarps;
}

// The attention of Swin block j: items (row block, window, head, split)
// over the grid, each running attend_long_rows on R query rows of one
// (window, head) over its split's batch elements.
template <int HD>
__device__ __noinline__ void attention_phase(const Params p, int splits,
                                             const LongPlan lp, int j,
                                             bool shifted, unsigned char* smem) {
  const int C = p.C, h = p.heads, N = p.window * p.window;
  const int nW = (p.H / p.window) * (p.W / p.window);
  const int R = lp.rows;
  const int row_blocks = (N + R - 1) / R;
  const int units = row_blocks * nW * h;
  const bf16* qkv = static_cast<const bf16*>(p.qkv);
  bf16* ctx = static_cast<bf16*>(p.ctx);
  for (int it = blockIdx.x; it < units * splits; it += gridDim.x) {
    const int s = it / units, u = it - s * units;
    const int wh = u / row_blocks, rb = u - wh * row_blocks;
    const int w = wh / h, head = wh - w * h;
    int b0, b1;
    split_range(p.B, splits, s, &b0, &b1);
    const size_t row0 = (size_t)w * N;  // window w's first token, element 0
    const PackedRows rows{qkv + row0 * 3 * C + head * HD, ctx + row0 * C + head * HD,
                          (long long)nW * N * 3 * C, (long long)nW * N * C,
                          3LL * C, (long long)C, C};
    attend_long_rows<HD, true>(
        rows, p.rpb + ((size_t)j * h + head) * N * N,
        shifted ? p.mask + (size_t)w * N * N : nullptr, N, b0, b1, p.scale, R,
        lp.parts, rb * R, smem);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_swin_blocks_tc_long_kernel(const Params p, const Plan plan,
                                 const LongPlan lp) {
  extern __shared__ __align__(16) unsigned char smem[];
  swin_blocks(p, plan, smem, [&](int j, bool shifted) {
    switch (p.C / p.heads) {
      case 8: attention_phase<8>(p, plan.splits, lp, j, shifted, smem); break;
      case 16: attention_phase<16>(p, plan.splits, lp, j, shifted, smem); break;
      case 32: attention_phase<32>(p, plan.splits, lp, j, shifted, smem); break;
      default: attention_phase<64>(p, plan.splits, lp, j, shifted, smem); break;
    }
  });
}

}  // namespace

extern "C" {

// Shared memory one block needs at R rows an item on `parts` warps a slab
// (a block that exceeds the card's is refused at launch); -1 where the
// shape is not taken.
long long fiber_fused_swin_blocks_tc_long_smem_bytes(int N, int hd, int R,
                                                     int parts) {
  return takes(N, hd, R, parts) ? (long long)smem_bytes(N, hd, R, parts) : -1;
}

// Resident blocks per SM; -1 on error or where the shape is not taken.
int fiber_fused_swin_blocks_tc_long_blocks_per_sm(int N, int hd, int R,
                                                  int parts) {
  if (!takes(N, hd, R, parts)) return -1;
  return blocks_per_sm(fused_swin_blocks_tc_long_kernel, kThreads,
                       smem_bytes(N, hd, R, parts));
}

// fiber_fused_swin_blocks_tc's contract (swin_stage_tc.cu) for 144 < N <=
// 352, with the attention's R query rows an item (a multiple of 16) on
// `parts` warps a 16-row slab.  Returns a CUDA error code (0 on success);
// a grid larger than the card holds at once is refused with
// cudaErrorCooperativeLaunchTooLarge.
int fiber_fused_swin_blocks_tc_long(
    const void* x, void* out, void* qkv, void* ctx, void* hid,
    const void* ln1_s, const void* ln1_b, const void* qkv_w, const void* qkv_b,
    const void* proj_w, const void* proj_b, const void* ln2_s,
    const void* ln2_b, const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* rpb, const void* mask, int n_blocks, int B,
    int H, int W, int C, int hidden, int window, int heads, int use_shift,
    float scale, int grid, int splits, int rows, int parts, int tile_qkv,
    int tile_proj, int tile_fc1, int tile_fc2, void* stream) {
  Plan plan{splits, {tile_qkv, tile_proj, tile_fc1, tile_fc2}};
  LongPlan lp{rows, parts};
  Params p{x, out, qkv, ctx, hid,
           static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
           qkv_w, qkv_b, proj_w, proj_b,
           static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
           fc1_w, fc1_b, fc2_w, fc2_b,
           static_cast<const float*>(rpb), static_cast<const float*>(mask),
           n_blocks, B, H, W, C, hidden, window, heads, use_shift, scale};
  if (!stack_takes(p, plan) || !takes(window * window, C / heads, rows, parts))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&p, &plan, &lp};
  return (int)launch_cooperative(
      fused_swin_blocks_tc_long_kernel, grid, kThreads,
      smem_bytes(window * window, C / heads, rows, parts), args,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
