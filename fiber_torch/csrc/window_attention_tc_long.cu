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
// fp32 and rounded on store.
//
// Why not window_attention_tc.cuh's routine: it stages a (window, head)'s
// whole fp32 bias tile (324 x 344 x 4 = 445,824 bytes at N = 324, against
// the 232,448 a block may use) and holds a 16-row slab's whole logits row
// in registers (NP / 2 = 168 fp32 a thread).  Here:
// * the grid is (nW * h, ceil(N / R), S): block (w * h + head, r, s) owns
//   query rows [r R, r R + R) of one (window, head), stages only those R
//   rows of the bias (R x (NP + 8) fp32) once, and walks the batch
//   elements of split s in ascending order, prefetching the next element's
//   q rows, K and V (all NP keys, bf16) by cp.async while it computes the
//   current one.  R (16 rows a warp) and S come from the wrapper's pure
//   plan (_long_plan); every output element is written by one thread: no
//   atomics, and two calls give the same bits;
// * each warp runs one 16-row slab in two passes over the keys on
//   mma.sync m16n8k16, 64 keys (8 n8 tiles, independent products) a step.
//   Pass 1 forms S = bias + q~ . K^T a block at a time and keeps each
//   lane's row max and sum of exponentials, rescaled when a block raises
//   the max; a quad reduction gives the row's max M and sum L.  Pass 2
//   forms each S block again (the same instructions, so the same bits),
//   p = exp(s - M) / L, rounds p to bf16 and feeds P.V.  QK^T runs twice
//   (+50% of the operations at hd = 32), and in return P is normalised
//   before it is rounded, as the plain version does: the result matches it
//   to within a bf16 ulp.  A one-pass online softmax would round P before
//   its normalisation.
//
// What bounds it on the card: bytes.  At stage 1 of 576^2 at B = 4 (nW =
// 64, h = 4, shifted) the fp32 bias is 107.5 MB and qkv with the output
// 85 MB, 0.057 ms at 3.35 TB/s; the products are 13.8 GFLOP (0.014 ms at
// 989 TFLOP/s; 20.6 GFLOP as run, QK^T twice).  The bias is read from
// device memory once per block and split; K and V once per row block.
//
// Shared memory at N = 324, hd = 32, R = 64 (the plan's choice there): the
// bias rows 64 x 344 fp32 (88,064 bytes) and two buffers of K, V (336 x 40
// bf16 each) and q (64 x 40), 205,824 in all: one block of 4 warps per SM,
// one warp on each of its schedulers.
// Limits: N <= 352, hd in {8, 16, 32, 64}, R a multiple of 16 up to 128,
// within a block's shared memory (R = 16 at N = 352, hd = 64).  wgmma, TMA
// and a one-pass softmax are left for a later version.

#include <stdint.h>

#include "window_attention_tc.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

constexpr int kLongMaxNP = 352;    // N <= 352
constexpr int kLongMaxWarps = 8;   // R <= 128 query rows a block
constexpr int kKeyTiles = 8;       // n8 key tiles a step of both passes: 64 keys

// Bytes of a block's shared memory: the bias rows, then two buffers of
// K (NP rows), V (NP rows) and q (R rows), each 16-byte aligned.
struct LongLayout {
  size_t bias, kv, q;
  __host__ __device__ LongLayout(int N, int hd, int R) {
    const int np = pad16(N);
    bias = align16(sizeof(float) * (size_t)R * tile_ld(np));
    kv = align16(sizeof(bf16) * (size_t)np * op_ld(hd));
    q = align16(sizeof(bf16) * (size_t)R * op_ld(hd));
  }
  __host__ __device__ size_t buffer() const { return 2 * kv + q; }
  __host__ __device__ size_t total() const { return bias + 2 * buffer(); }
};

bool long_takes(int N, int hd, int R) {
  return N >= 1 && N <= kLongMaxNP
      && (hd == 8 || hd == 16 || hd == 32 || hd == 64)
      && R >= 16 && R <= 16 * kLongMaxWarps && R % 16 == 0;
}

// K and V (rows < N) and q (the block's nq rows from r0) of batch element
// b into one buffer, 16 bytes a copy.
template <int HD>
__device__ __forceinline__ void stage_long(unsigned char* buf, const LongLayout& L,
                                           const PackedRows& rows, int b, int N,
                                           int r0, int nq) {
  constexpr int CH = HD / 8;                 // 16-byte chunks in a row
  constexpr int LDO = op_ld(HD);
  bf16* Ks = reinterpret_cast<bf16*>(buf);
  bf16* Vs = reinterpret_cast<bf16*>(buf + L.kv);
  bf16* Qs = reinterpret_cast<bf16*>(buf + 2 * L.kv);
  const int nkv = N * CH;
  for (int i = threadIdx.x; i < 2 * nkv + nq * CH; i += blockDim.x) {
    if (i < 2 * nkv) {
      const int op = i >= nkv;               // K, V
      const int rem = i - op * nkv;
      const int n = rem / CH;
      const int ch = rem - n * CH;
      cp_async16((op ? Vs : Ks) + n * LDO + 8 * ch,
                 (op ? rows.v(b) : rows.k(b)) + (size_t)n * rows.in_rs + 8 * ch);
    } else {
      const int rem = i - 2 * nkv;
      const int n = rem / CH;
      const int ch = rem - n * CH;
      cp_async16(Qs + n * LDO + 8 * ch,
                 rows.q(b) + (size_t)(r0 + n) * rows.in_rs + 8 * ch);
    }
  }
}

// Logits (local rows la, lb; columns 8t + c2, + 1) as the staged fp32 bias
// rows: -inf on padded keys, 0 on rows past the block's nq.
__device__ __forceinline__ void bias_rows(float (&d)[4], const float* Bs, int LDP,
                                          int N, int nq, int t, int la, int lb,
                                          int c2) {
  const int col = 8 * t + c2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr ? lb : la;
    const float2 v = row < nq ? *reinterpret_cast<const float2*>(Bs + row * LDP + col)
                              : make_float2(0.f, 0.f);
    d[2 * hr] = col < N ? v.x : -INFINITY;
    d[2 * hr + 1] = col + 1 < N ? v.y : -INFINITY;
  }
}

// S tiles t and t + 1 of one slab: the bias rows plus q~ . K^T.
template <int KQ, int LDO>
__device__ __forceinline__ void logits_pair(float (&s0)[4], float (&s1)[4],
                                            const uint32_t (&qa)[KQ][4],
                                            const bf16* Ks, const float* Bs,
                                            int LDP, int N, int nq, int t, int la,
                                            int lb, int c2, int lane) {
  bias_rows(s0, Bs, LDP, N, nq, t, la, lb, c2);
  bias_rows(s1, Bs, LDP, N, nq, t + 1, la, lb, c2);
  key_pair_product<KQ, LDO>(s0, s1, qa, Ks, t, lane);
}

// S tiles t0 ... t0 + TILES - 1 of one slab, their products independent of
// one another, so that the warp has TILES / 2 chains of mma in flight.
template <int TILES, int KQ, int LDO>
__device__ __forceinline__ void logits_block(float (&s)[TILES][4],
                                             const uint32_t (&qa)[KQ][4],
                                             const bf16* Ks, const float* Bs,
                                             int LDP, int N, int nq, int t0,
                                             int la, int lb, int c2, int lane) {
#pragma unroll
  for (int u = 0; u < TILES; u += 2)
    logits_pair<KQ, LDO>(s[u], s[u + 1], qa, Ks, Bs, LDP, N, nq, t0 + u, la,
                         lb, c2, lane);
}

// A lane's running max m and sum l of exp(s - m) over its logits of one
// row (accumulator elements e and e + 1 of each tile), taking a block of
// tiles: the max over the block, one rescale of the sum when the max
// grows, then the block's exponentials added tile by tile.
template <int TILES>
__device__ __forceinline__ void online(float& m, float& l,
                                       const float (&s)[TILES][4], int e) {
  float t = fmaxf(s[0][e], s[0][e + 1]);
#pragma unroll
  for (int u = 1; u < TILES; ++u) t = fmaxf(t, fmaxf(s[u][e], s[u][e + 1]));
  if (t > m) {
    l *= exp2f((m - t) * kTcLog2e);
    m = t;
  }
  if (m > -INFINITY) {             // else all of this lane's keys so far are padded
    const float ml = m * kTcLog2e;
    float add = 0.f;
#pragma unroll
    for (int u = 0; u < TILES; ++u)
      add += exp2f(fmaf(s[u][e], kTcLog2e, -ml)) + exp2f(fmaf(s[u][e + 1], kTcLog2e, -ml));
    l += add;
  }
}

// Pass 1 over key tiles [t0, t0 + TILES): rows a and b.
template <int TILES, int KQ, int LDO>
__device__ __forceinline__ void pass1(float& ma, float& sa, float& mb, float& sb,
                                      const uint32_t (&qa)[KQ][4], const bf16* Ks,
                                      const float* Bs, int LDP, int N, int nq,
                                      int t0, int la, int lb, int c2, int lane) {
  float s[TILES][4];
  logits_block<TILES, KQ, LDO>(s, qa, Ks, Bs, LDP, N, nq, t0, la, lb, c2, lane);
  online<TILES>(ma, sa, s, 0);
  online<TILES>(mb, sb, s, 2);
}

// Pass 2 over key tiles [t0, t0 + TILES): p = round(exp(s - M) / L), P.V
// into o, P packed from the accumulators into the A fragments.
template <int TILES, int KQ, int LDO, int NC>
__device__ __forceinline__ void pass2(float (&o)[NC][4], const uint32_t (&qa)[KQ][4],
                                      const bf16* Ks, const bf16* Vs,
                                      const float* Bs, int LDP, int N, int nq,
                                      int t0, int la, int lb, int c2, int lane,
                                      float mla, float inva, float mlb, float invb) {
  float s[TILES][4];
  logits_block<TILES, KQ, LDO>(s, qa, Ks, Bs, LDP, N, nq, t0, la, lb, c2, lane);
#pragma unroll
  for (int u = 0; u < TILES; u += 2) {
    const uint32_t pa[4] = {
        pack(exp2f(fmaf(s[u][0], kTcLog2e, -mla)) * inva,
             exp2f(fmaf(s[u][1], kTcLog2e, -mla)) * inva),
        pack(exp2f(fmaf(s[u][2], kTcLog2e, -mlb)) * invb,
             exp2f(fmaf(s[u][3], kTcLog2e, -mlb)) * invb),
        pack(exp2f(fmaf(s[u + 1][0], kTcLog2e, -mla)) * inva,
             exp2f(fmaf(s[u + 1][1], kTcLog2e, -mla)) * inva),
        pack(exp2f(fmaf(s[u + 1][2], kTcLog2e, -mlb)) * invb,
             exp2f(fmaf(s[u + 1][3], kTcLog2e, -mlb)) * invb)};
#pragma unroll
    for (int j = 0; j < NC; j += 2) {
      uint32_t vb[4];
      ldsm_x4_t(vb, Vs + (8 * (t0 + u) + (lane & 15)) * LDO + 8 * (j + (lane >> 4)));
      mma(o[j], pa, vb[0], vb[1]);
      mma(o[j + 1], pa, vb[2], vb[3]);
    }
  }
}

// One warp's 16-row slab (local rows l0 ... l0 + 15 of the block's rows) of
// one staged batch element, stored at local rows < nq of dst.  Both passes
// walk the keys in blocks of kKeyTiles n8 tiles, the last block with the
// 2, 4 or 6 tiles left (NT is even).
template <int HD>
__device__ __forceinline__ void attend_slab_long(
    const bf16* Qs, const bf16* Ks, const bf16* Vs, const float* Bs, int LDP,
    int N, int nq, int l0, float scale, bf16* dst, long long out_rs) {
  constexpr int HP = chans(HD);
  constexpr int LDO = op_ld(HD);
  constexpr int KQ = HP / 16;      // k16 steps over the channels
  constexpr int NC = HP / 8;       // n8 tiles over the channels
  const int NT = pad16(N) / 8;     // n8 tiles over the keys
  const int full = NT - NT % kKeyTiles;
  const int lane = threadIdx.x & 31;
  const int c2 = 2 * (lane & 3);
  const int la = l0 + (lane >> 2);
  const int lb = la + 8;

  uint32_t qa[KQ][4];              // round(q * scale), the A fragments
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    ldsm_x4(qa[kk], Qs + (l0 + (lane & 15)) * LDO + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = unpack(qa[kk][r]);
      qa[kk][r] = pack(f.x * scale, f.y * scale);
    }
  }

  // pass 1: each row's max and sum of exponentials
  float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f;
  for (int t0 = 0; t0 < full; t0 += kKeyTiles)
    pass1<kKeyTiles, KQ, LDO>(ma, sa, mb, sb, qa, Ks, Bs, LDP, N, nq, t0, la,
                              lb, c2, lane);
  switch (NT - full) {
    case 2: pass1<2, KQ, LDO>(ma, sa, mb, sb, qa, Ks, Bs, LDP, N, nq, full, la, lb, c2, lane); break;
    case 4: pass1<4, KQ, LDO>(ma, sa, mb, sb, qa, Ks, Bs, LDP, N, nq, full, la, lb, c2, lane); break;
    case 6: pass1<6, KQ, LDO>(ma, sa, mb, sb, qa, Ks, Bs, LDP, N, nq, full, la, lb, c2, lane); break;
    default: break;
  }
  const float Ma = quad_max(ma);
  const float Mb = quad_max(mb);
  const float inva = 1.f / quad_sum(sa * exp2f((ma - Ma) * kTcLog2e));
  const float invb = 1.f / quad_sum(sb * exp2f((mb - Mb) * kTcLog2e));
  const float mla = Ma * kTcLog2e;
  const float mlb = Mb * kTcLog2e;

  // pass 2: out = round(exp(s - M) / L) . V
  float o[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j) zero(o[j]);
  for (int t0 = 0; t0 < full; t0 += kKeyTiles)
    pass2<kKeyTiles, KQ, LDO, NC>(o, qa, Ks, Vs, Bs, LDP, N, nq, t0, la, lb, c2,
                                  lane, mla, inva, mlb, invb);
  switch (NT - full) {
    case 2: pass2<2, KQ, LDO, NC>(o, qa, Ks, Vs, Bs, LDP, N, nq, full, la, lb, c2, lane, mla, inva, mlb, invb); break;
    case 4: pass2<4, KQ, LDO, NC>(o, qa, Ks, Vs, Bs, LDP, N, nq, full, la, lb, c2, lane, mla, inva, mlb, invb); break;
    case 6: pass2<6, KQ, LDO, NC>(o, qa, Ks, Vs, Bs, LDP, N, nq, full, la, lb, c2, lane, mla, inva, mlb, invb); break;
    default: break;
  }

#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (la < nq)
      *reinterpret_cast<uint32_t*>(dst + la * out_rs + 8 * j + c2) =
          pack(o[j][0], o[j][1]);
    if (lb < nq)
      *reinterpret_cast<uint32_t*>(dst + lb * out_rs + 8 * j + c2) =
          pack(o[j][2], o[j][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kLongMaxWarps * 32, 1)
window_attention_fwd_tc_long_kernel(const bf16* __restrict__ qkv,
                                    const float* __restrict__ bias,
                                    bf16* __restrict__ out, int B, int nW, int N,
                                    int h, long long bias_w_stride, float scale) {
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int R = (blockDim.x >> 5) * 16;
  const int r0 = blockIdx.y * R;
  const int nq = min(R, N - r0);
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);
  extern __shared__ __align__(16) unsigned char smem[];

  const LongLayout L(N, HD, R);
  const int LDP = tile_ld(pad16(N));
  float* Bs = reinterpret_cast<float*>(smem);
  unsigned char* bufs = smem + L.bias;

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
  const float* src = bias + (size_t)w * bias_w_stride + ((size_t)head * N + r0) * N;
  if ((N & 3) == 0) {
    const int n4 = N / 4;
    for (int i = threadIdx.x; i < nq * n4; i += blockDim.x) {
      const int r = i / n4;
      const int c = 4 * (i - r * n4);
      cp_async16(Bs + r * LDP + c, src + (size_t)r * N + c);
    }
  } else {
    for (int i = threadIdx.x; i < nq * N; i += blockDim.x) {
      const int r = i / N;
      cp_async4(Bs + r * LDP + (i - r * N), src + i);
    }
  }
  if (b_begin < b_end) stage_long<HD>(bufs, L, rows, b_begin, N, r0, nq);
  cp_async_commit();

  for (int b = b_begin; b < b_end; ++b) {
    const int cur = (b - b_begin) & 1;
    if (b + 1 < b_end) {           // prefetch the next element
      stage_long<HD>(bufs + (cur ^ 1) * L.buffer(), L, rows, b + 1, N, r0, nq);
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
    if (16 * warp < nq)            // warps past the last row block's rows idle
      attend_slab_long<HD>(Qs, Ks, Vs, Bs, LDP, N, nq, 16 * warp, scale,
                           rows.o(b) + (size_t)r0 * rows.out_rs, rows.out_rs);
    __syncthreads();               // every warp is done with this buffer
  }
}

template <int HD>
cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int nW,
                   int N, int h, long long bias_w_stride, float scale, int R,
                   int splits, cudaStream_t stream) {
  auto kernel = window_attention_fwd_tc_long_kernel<HD>;
  const size_t smem = LongLayout(N, HD, R).total();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(nW * h, (N + R - 1) / R, splits), R / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), B, nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of R query rows needs; -1 where the shape is not
// taken.
long long fiber_window_attention_tc_long_smem_bytes(int N, int hd, int R) {
  return long_takes(N, hd, R) ? (long long)LongLayout(N, hd, R).total() : -1;
}

// Resident blocks per SM at R query rows a block; -1 on error or where the
// shape is not taken.
int fiber_window_attention_tc_long_blocks_per_sm(int N, int hd, int R) {
  if (!long_takes(N, hd, R)) return -1;
  const size_t smem = LongLayout(N, hd, R).total();
  const int threads = R / 16 * 32;
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
// of 16); 1 <= splits <= B.
int fiber_window_attention_tc_long_fwd(const void* qkv, const void* bias,
                                       void* out, int B, int nW, int N, int h,
                                       int hd, long long bias_w_stride,
                                       float scale, int R, int splits,
                                       void* stream) {
  if (!long_takes(N, hd, R) || splits < 1 || splits > B) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return (int)launch<8>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, splits, s);
    case 16: return (int)launch<16>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, splits, s);
    case 32: return (int)launch<32>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, splits, s);
    default: return (int)launch<64>(qkv, bias, out, B, nW, N, h, bias_w_stride, scale, R, splits, s);
  }
}

}  // extern "C"
