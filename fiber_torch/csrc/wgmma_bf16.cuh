// Warpgroup (wgmma) helpers for Hopper (sm_90a), shared by the
// long-window backward's kernels (window_attention_bwd_tc_long.cu): the
// shared-memory matrix descriptor of the "core" operand layout, the
// m64nNk16 bf16 product with its A operand in registers and B in shared
// memory, the fences and waits, the mbarriers of a producer / consumer
// ring and the bulk copy that lands on them.
//
// The core layout.  A staged bf16 operand of T rows (tokens, T a multiple
// of 8) and HP channels is stored as HP / 8 planes of 16-byte chunks: the
// 8 channels 8c ... 8c + 7 of row r at byte (c T + r) 16 (core_at).  Eight
// consecutive rows of one plane are one 128-byte "core matrix", the unit
// wgmma reads without a swizzle; ldmatrix reads the same 8-row blocks, so
// neither has bank conflicts.  A tile is read two ways:
// * K-major (tokens are the product's N, channels its K: B of S^T =
//   K . q~^T or dP^T = V . dO^T): core matrices 128 bytes apart along the
//   tokens, T 16 bytes apart along the channels; a k16 step is 2 planes;
// * MN-major (tokens are K, channels N: B of dv += P^T . dO or dk +=
//   dS^T . q): the same core matrices, read transposed (imm-trans-b = 1);
//   a k16 step is 16 tokens (256 bytes).  Here the descriptor's leading
//   offset is the step along the tokens (128 bytes) and its stride offset
//   the step along the channels (T 16 bytes), the reverse of the K-major
//   read (a layout probe on an H100 took each assignment in turn).
//
// Fragments.  A warpgroup is 4 warps; warp w of it owns rows 16 w ...
// 16 w + 15 of the 64-row product.  Its A fragment of one k16 step and its
// fp32 accumulators of each n8 tile are laid out as mma.sync m16n8k16's
// (mma_bf16.cuh), so accumulators packed to bf16 pairwise are the A
// fragment of the next product, as on the mma.sync path.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "window_attention_bwd_common.cuh"

namespace fiber {

// byte offset of row r, channel plane c of a core-layout tile of T rows
__host__ __device__ constexpr int core_at(int r, int c, int T) {
  return (c * T + r) * 16;
}

// the shared-memory descriptor of a no-swizzle operand at p: leading and
// stride byte offsets (multiples of 16), layout type 0
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
       | ((uint64_t)(sbo >> 4) << 32);
}

// B of a product read K-major from a core-layout tile of T rows, from row
// n0 (a multiple of 8), k16 step kk
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int T, int n0,
                                                int kk) {
  return smem_desc(static_cast<const unsigned char*>(tile)
                       + core_at(n0, 2 * kk, T), T * 16, 128);
}

// B read MN-major from a core-layout tile of T rows: k16 step kk over the
// tokens, all channels
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile, int T,
                                                 int kk) {
  return smem_desc(static_cast<const unsigned char*>(tile) + 256 * kk, 128,
                   T * 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses to accumulators (or A operands)
// of an in-flight product across the wait that ends it
template <int T>
__device__ __forceinline__ void fence_regs(float (&d)[T][4]) {
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[u][i]) :: "memory");
}
template <int T>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[T][4]) {
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[u][i]) :: "memory");
}

// d (64 x N fp32, N / 8 n8 tiles a warp) += A (64 x 16 bf16, the warp's
// fragment a) . B (16 x N, the descriptor; TNSP = 1: read MN-major)
template <int TNSP>
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %13;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TNSP), "r"(1));
}

template <int TNSP>
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TNSP), "r"(1));
}

template <int TNSP>
__device__ __forceinline__ void wgmma_rs(float (&d)[6][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %29;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TNSP), "r"(1));
}

template <int TNSP>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TNSP), "r"(1));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the block (then __syncthreads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrives on `bar` when every cp.async this thread issued before has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// the barrier's phase also waits for `bytes` more of bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the tensor memory accelerator's bulk copy, counted
// on `bar` as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// waits until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before the async proxy's reads of them (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace fiber
