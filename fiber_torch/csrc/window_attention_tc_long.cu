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
// <= 16 warps, P <= NP / 16 (every part has a real key), within a block's shared memory.  wgmma and TMA are left for
// a later version.

#include <stdint.h>

#include "window_attention_tc_long.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

// Bytes of a block's shared memory: the staged bias rows, two buffers of K
// and V (NP rows each) and q (R rows), then the parts' exchange: P.V
// accumulators of parts 1 ... P - 1 (16 x HP fp32 a slab and part) and
// every part's (max, sum) of each row.
struct FwdLongLayout {
  size_t bias, kv, q, acc, stats;
  __host__ __device__ FwdLongLayout(int N, int hd, int R, int parts) {
    const int np = pad16(N);
    bias = align16(sizeof(float) * (size_t)R * tile_ld(np));
    kv = align16(sizeof(bf16) * (size_t)np * op_ld(hd));
    q = align16(sizeof(bf16) * (size_t)R * op_ld(hd));
    acc = align16(sizeof(float) * (size_t)R * (parts - 1) * chans(hd));
    stats = align16(sizeof(float2) * (size_t)R * parts);
  }
  __host__ __device__ size_t buffer() const { return 2 * kv + q; }
  __host__ __device__ size_t total() const {
    return bias + 2 * buffer() + acc + stats;
  }
};

bool long_takes(int N, int hd, int R, int parts) {
  return N >= 1 && N <= kLongMaxNP
      && (hd == 8 || hd == 16 || hd == 32 || hd == 64)
      && R >= 16 && R % 16 == 0 && parts >= 1 && parts <= pad16(N) / 16
      && R / 16 * parts * 32 <= kLongMaxThreads;
}

// K and V (rows < N) and q (the block's nq rows from r0) of batch element
// b into one buffer, 16 bytes a copy.
template <int HD>
__device__ __forceinline__ void stage_element(unsigned char* buf,
                                              const FwdLongLayout& L,
                                              const PackedRows& rows, int b,
                                              int N, int r0, int nq) {
  copy_rows<HD>(reinterpret_cast<bf16*>(buf), rows.k(b), rows.in_rs, N);
  copy_rows<HD>(reinterpret_cast<bf16*>(buf + L.kv), rows.v(b), rows.in_rs, N);
  copy_rows<HD>(reinterpret_cast<bf16*>(buf + 2 * L.kv),
                rows.q(b) + (size_t)r0 * rows.in_rs, rows.in_rs, nq);
}

template <int HD>
__global__ void __launch_bounds__(kLongMaxThreads, 1)
window_attention_fwd_tc_long_kernel(const bf16* __restrict__ qkv,
                                    const float* __restrict__ bias,
                                    bf16* __restrict__ out, int B, int nW, int N,
                                    int h, long long bias_w_stride, float scale,
                                    int parts) {
  constexpr int HP = chans(HD);
  constexpr int LDO = op_ld(HD);
  constexpr int KQ = HP / 16;      // k16 steps over the channels
  constexpr int NC = HP / 8;       // n8 tiles over the channels
  const int w = blockIdx.y / h;
  const int head = blockIdx.y - w * h;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slab = warp / parts;
  const int part = warp - slab * parts;
  const int c2 = 2 * (lane & 3);
  const int la = 16 * slab + (lane >> 2);
  const int lb = la + 8;
  const int R = (blockDim.x >> 5) / parts * 16;
  const int r0 = blockIdx.x * R;
  const int nq = min(R, N - r0);
  const int NP = pad16(N);
  const int LDP = tile_ld(NP);
  // the part's key tiles: a run of the NP / 16 tile pairs
  const int pairs = NP / 16;
  const int t_begin = 2 * (part * pairs / parts);
  const int t_end = 2 * ((part + 1) * pairs / parts);
  const bool active = 16 * slab < nq;  // slabs past the last row block's rows idle
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);

  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLongLayout L(N, HD, R, parts);
  float* Bs = reinterpret_cast<float*>(smem);
  unsigned char* bufs = smem + L.bias;
  float* acc_x = reinterpret_cast<float*>(bufs + 2 * L.buffer());
  float2* stat_x = reinterpret_cast<float2*>(bufs + 2 * L.buffer() + L.acc);

  const size_t row0 = (size_t)w * N;  // window w's first token, element 0
  const PackedRows rows{qkv + row0 * 3 * C + head * HD,
                        out + row0 * C + head * HD,
                        (long long)nW * N * 3 * C, (long long)nW * N * C,
                        3LL * C, (long long)C, C};

  // padded rows and channels stay zero: only real ones are staged
  {
    uint4* z = reinterpret_cast<uint4*>(bufs);
    const int n16 = (int)(2 * L.buffer() / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  copy_f32(Bs, LDP, bias + (size_t)w * bias_w_stride + ((size_t)head * N + r0) * N,
           N, nq, N, (N & 3) == 0);
  if (b_begin < b_end) stage_element<HD>(bufs, L, rows, b_begin, N, r0, nq);
  cp_async_commit();

  for (int b = b_begin; b < b_end; ++b) {
    const int cur = (b - b_begin) & 1;
    if (b + 1 < b_end) {           // prefetch the next element
      stage_element<HD>(bufs + (cur ^ 1) * L.buffer(), L, rows, b + 1, N, r0, nq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // element b (and the bias) are staged
    const unsigned char* buf = bufs + cur * L.buffer();
    const bf16* Ks = reinterpret_cast<const bf16*>(buf);
    const bf16* Vs = reinterpret_cast<const bf16*>(buf + L.kv);
    const bf16* Qs = reinterpret_cast<const bf16*>(buf + 2 * L.kv);

    // pass 1: the part's (max, sum) of each row, traded with the others
    uint32_t qa[KQ][4];            // round(q * scale), the A fragments
    float Ma = 0.f, Mb = 0.f, La = 0.f, Lb = 0.f;
    if (active) {
      slab_fragments<KQ, LDO>(qa, Qs, 16 * slab, scale, lane);
      float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f, unused = 0.f;
      tile_steps(t_begin, t_end, [&](auto T, int t0) {
        constexpr int TL = decltype(T)::value;
        float s[TL][4];
        logits_step<TL, KQ, LDO>(s, qa, Ks + 8 * t0 * LDO, Bs + 8 * t0, LDP, nq,
                                 N - 8 * t0, la, lb, c2, lane);
        online<TL, false>(ma, sa, unused, s, s, 0);
        online<TL, false>(mb, sb, unused, s, s, 2);
      });
      Ma = quad_max(ma);
      Mb = quad_max(mb);
      La = quad_sum(sa * exp2f((ma - Ma) * kTcLog2e));
      Lb = quad_sum(sb * exp2f((mb - Mb) * kTcLog2e));
      if (parts > 1 && (lane & 3) == 0) {
        stat_x[(slab * parts + part) * 16 + (lane >> 2)] = make_float2(Ma, La);
        stat_x[(slab * parts + part) * 16 + (lane >> 2) + 8] = make_float2(Mb, Lb);
      }
    }
    if (parts > 1) __syncthreads();

    // pass 2: out = round(exp(s - M) / L) . V over the part's keys
    float o[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) zero(o[j]);
    if (active) {
      if (parts > 1) {
        const float2* st = stat_x + slab * parts * 16 + (lane >> 2);
        Ma = Mb = -INFINITY;
        for (int p = 0; p < parts; ++p) {
          Ma = fmaxf(Ma, st[16 * p].x);
          Mb = fmaxf(Mb, st[16 * p + 8].x);
        }
        La = Lb = 0.f;
        for (int p = 0; p < parts; ++p) {
          La += st[16 * p].y * exp2f((st[16 * p].x - Ma) * kTcLog2e);
          Lb += st[16 * p + 8].y * exp2f((st[16 * p + 8].x - Mb) * kTcLog2e);
        }
      }
      const float mla = Ma * kTcLog2e, inva = 1.f / La;
      const float mlb = Mb * kTcLog2e, invb = 1.f / Lb;
      tile_steps(t_begin, t_end, [&](auto T, int t0) {
        constexpr int TL = decltype(T)::value;
        float s[TL][4];
        logits_step<TL, KQ, LDO>(s, qa, Ks + 8 * t0 * LDO, Bs + 8 * t0, LDP, nq,
                                 N - 8 * t0, la, lb, c2, lane);
        probs<TL>(s, mla, inva, mlb, invb);
        pv_acc<TL, NC, LDO>(o, s, Vs + 8 * t0 * LDO, lane);
      });
      // the parts' accumulators meet in part 0, in the order of the parts,
      // each lane's elements at the same place in every part
      if (part > 0) {
        float* mine = acc_x + ((size_t)slab * (parts - 1) + part - 1) * 16 * HP;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) mine[(j * 4 + i) * 32 + lane] = o[j][i];
      }
    }
    if (parts > 1) __syncthreads();
    if (active && part == 0) {
      for (int p = 1; p < parts; ++p) {
        const float* theirs = acc_x + ((size_t)slab * (parts - 1) + p - 1) * 16 * HP;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[j][i] += theirs[(j * 4 + i) * 32 + lane];
      }
      store_rows<HD, NC>(rows.o(b) + (size_t)r0 * rows.out_rs, rows.out_rs, o,
                         1.f, la, lb, nq, c2);
    }
    __syncthreads();               // every warp is done with this buffer
  }
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
