// The sampling of the modulated deformable convolution (DCNv2, 3x3,
// padding 1) for Hopper (sm_90a): its im2col matrix in one launch.
//
// Added to the port; it replaces no TPU kernel.  The JAX package's
// fiber_tpu/detection/deform_conv.py::modulated_deform_conv2d is plain JAX
// (gathers that XLA fuses), so the TPU had no kernel here.  The port's
// plain version (fiber_torch/detection/deform_conv.py::
// _modulated_deform_conv2d_plain) runs about 35 small PyTorch operations a
// call: four corner gathers into fp32 temporaries of (B, Ho, Wo, 9, Cin)
// each, about 20 GB of traffic at FIBER-B's P3 level for a 620 MB result,
// and the DyHead calls it 78 times a pass.  This kernel writes the same
// matrix, bit for bit, in one pass:
//
//     cols[(b, ho, wo), k * Cin + c] =
//         T(sum over the 4 corners of x[b, c, y, x] * weight)
//           * (valid ? mask[b, k, ho, wo] : 0)
//
// with the plain version's rounding step by step: the grid point
// base = T(T(i) * stride) (the plain version builds the grid in x's dtype
// T), the sample s = (base + (tap - 1)) + offset in fp32, valid for s in
// (-1, H) x (-1, W), the corner weights (1 - ly) * (1 - lx) ... in fp32,
// the four products summed left to right, times (valid * mask), rounded
// to T.  Every operation is an explicit __fadd_rn / __fmul_rn, so nvcc
// contracts nothing into an FMA.  A corner outside the map reads 0, as the
// plain version's zero border does; a sample outside (-1, H) x (-1, W)
// reads its corners where the plain version's clamped indices read them
// and is multiplied by 0, so even the sign of its zero matches.
//
// What bounds it: bytes.  x is read from device memory about once (the 36
// reads of each pixel by neighbouring samples hit L2) and cols written
// once: at P3, B = 8 (100 x 168, 256 channels) 69 + 619 MB, 0.21 ms at
// 3.35 TB/s.  Layout of the work: one warp per (output position, tap),
// items in row-major (b, ho, wo, tap) order, so a block's warps read
// neighbouring pixels and write one contiguous stretch of cols.  The warp
// computes the sample position, its validity and the four corner weights
// once, in fp32 (every lane the same values, no shuffles); each lane then
// reads 16 bytes of each corner's NHWC row (8 bf16 or 4 fp32 channels; at
// Cin = 256 in bf16 one coalesced 512-byte row a corner), sums in fp32 and
// writes 16 bytes of cols.  Where Cin is not a multiple of the 16-byte
// vector, or a pointer not 16-byte aligned, the lanes go element by element.
//
// Inputs: x (B, H, W, Cin) contiguous, in fp32 or bf16; offset (B, 18, Ho,
// Wo) and mask (B, 9, Ho, Wo) in fp32 or bf16, each of any strides (the
// DyHead's offsets are a slice of the offset conv's 27 channels, and the
// conv over the level below reads a flat prefix of each image's buffer,
// so the batch stride is not 18 Ho Wo); cols (B Ho Wo, 9 Cin) in x's dtype.

#include <stdint.h>

#include "window_attention_common.cuh"

namespace {

using namespace fiber;

constexpr int kWarps = 8;
constexpr int kTaps = 9;

struct Strides {
  long long b, c, h, w;
};

__device__ __forceinline__ float load_as_float(const void* p, long long i,
                                               bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 16 bytes of T as fp32 lanes, and back
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The four corners' NHWC rows (nullptr where a corner lies outside the
// map), their weights and the sample's scale (valid * mask).
struct Sample {
  const void* row[4];
  float w[4];
  float scale;
};

template <typename T>
__device__ __forceinline__ Sample sample_of(
    const T* __restrict__ x, const void* __restrict__ offset,
    const void* __restrict__ mask, Strides os, Strides ms, bool off_bf16,
    bool mask_bf16, int b, int ho, int wo, int k, int Cin, int H, int W,
    int stride) {
  const float dy = load_as_float(
      offset, b * os.b + (2 * k) * os.c + ho * os.h + wo * os.w, off_bf16);
  const float dx = load_as_float(
      offset, b * os.b + (2 * k + 1) * os.c + ho * os.h + wo * os.w, off_bf16);
  const float m = load_as_float(
      mask, b * ms.b + k * ms.c + ho * ms.h + wo * ms.w, mask_bf16);
  // the grid point in x's dtype: T(T(i) * stride), as the plain version's
  // torch.arange(..).to(dtype) * stride rounds it
  const float base_y = round_to<T>(__fmul_rn(round_to<T>((float)ho), (float)stride));
  const float base_x = round_to<T>(__fmul_rn(round_to<T>((float)wo), (float)stride));
  const float sy = __fadd_rn(__fadd_rn(base_y, (float)(k / 3 - 1)), dy);
  const float sx = __fadd_rn(__fadd_rn(base_x, (float)(k % 3 - 1)), dx);
  const bool valid = sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W;
  const float y0f = floorf(sy), x0f = floorf(sx);
  const float ly = __fsub_rn(sy, y0f), lx = __fsub_rn(sx, x0f);
  const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
  // the plain version clamps the top-left corner to [-1, H - 1] x [-1, W - 1]
  const int y0 = (int)fminf(fmaxf(y0f, -1.f), (float)(H - 1));
  const int x0 = (int)fminf(fmaxf(x0f, -1.f), (float)(W - 1));
  Sample s;
  s.w[0] = __fmul_rn(hy, hx);
  s.w[1] = __fmul_rn(hy, lx);
  s.w[2] = __fmul_rn(ly, hx);
  s.w[3] = __fmul_rn(ly, lx);
  s.scale = __fmul_rn(valid ? 1.f : 0.f, m);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = y0 + (i >> 1), xx = x0 + (i & 1);
    s.row[i] = (y >= 0 && y < H && xx >= 0 && xx < W)
        ? static_cast<const void*>(x + (((long long)b * H + y) * W + xx) * Cin)
        : nullptr;
  }
  return s;
}

// ((v0 w0 + v1 w1) + v2 w2) + v3 w3, times the scale: the plain version's
// order of operations
__device__ __forceinline__ float combine(const float* v, const Sample& s) {
  float acc = __fmul_rn(v[0], s.w[0]);
  acc = __fadd_rn(acc, __fmul_rn(v[1], s.w[1]));
  acc = __fadd_rn(acc, __fmul_rn(v[2], s.w[2]));
  acc = __fadd_rn(acc, __fmul_rn(v[3], s.w[3]));
  return __fmul_rn(acc, s.scale);
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kWarps * 32)
deform_im2col_kernel(const T* __restrict__ x, const void* __restrict__ offset,
                     const void* __restrict__ mask, T* __restrict__ cols,
                     long long items, int Cin, int H, int W, int Ho, int Wo,
                     int stride, Strides os, Strides ms, bool off_bf16,
                     bool mask_bf16) {
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= items) return;
  const int lane = threadIdx.x & 31;
  const int k = (int)(item % kTaps);
  const long long pos = item / kTaps;
  const int wo = (int)(pos % Wo);
  const long long row = pos / Wo;
  const int ho = (int)(row % Ho);
  const int b = (int)(row / Ho);
  const Sample s = sample_of<T>(x, offset, mask, os, ms, off_bf16, mask_bf16,
                                b, ho, wo, k, Cin, H, W, stride);
  T* out = cols + item * Cin;
  if (VECTOR) {
    constexpr int n = Vec<T>::n;
    for (int c = lane * n; c < Cin; c += 32 * n) {
      float v[4][n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 u = s.row[i]
            ? *reinterpret_cast<const uint4*>(static_cast<const T*>(s.row[i]) + c)
            : make_uint4(0u, 0u, 0u, 0u);
        Vec<T>::unpack(u, v[i]);
      }
      float o[n];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const float corner[4] = {v[0][j], v[1][j], v[2][j], v[3][j]};
        o[j] = combine(corner, s);
      }
      *reinterpret_cast<uint4*>(out + c) = Vec<T>::pack(o);
    }
  } else {
    for (int c = lane; c < Cin; c += 32) {
      float corner[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        corner[i] = s.row[i] ? to_float(static_cast<const T*>(s.row[i])[c]) : 0.f;
      out[c] = from_float<T>(combine(corner, s));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* offset, const void* mask,
                   void* cols, int B, int Cin, int H, int W, int Ho, int Wo,
                   int stride, Strides os, Strides ms, bool off_bf16,
                   bool mask_bf16, cudaStream_t stream) {
  const long long items = (long long)B * Ho * Wo * kTaps;
  if (items == 0 || Cin == 0) return cudaSuccess;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vector = Cin % Vec<T>::n == 0
      && reinterpret_cast<uintptr_t>(x) % 16 == 0
      && reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  auto kernel = vector ? deform_im2col_kernel<T, true>
                       : deform_im2col_kernel<T, false>;
  kernel<<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), offset, mask, static_cast<T*>(cols), items,
      Cin, H, W, Ho, Wo, stride, os, ms, off_bf16, mask_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x (B, H, W, Cin) contiguous and cols (B Ho Wo, 9 Cin) in x's dtype;
// offset (B, 18, Ho, Wo) and mask (B, 9, Ho, Wo) with element strides
// o_* / m_*.  dtypes: 0 fp32, 1 bf16.
int fiber_deform_im2col(const void* x, const void* offset, const void* mask,
                        void* cols, int B, int Cin, int H, int W, int Ho,
                        int Wo, int stride, long long o_b, long long o_c,
                        long long o_h, long long o_w, long long m_b,
                        long long m_c, long long m_h, long long m_w,
                        int x_dtype, int offset_dtype, int mask_dtype,
                        void* stream) {
  if (B < 0 || Cin < 0 || H < 1 || W < 1 || Ho < 0 || Wo < 0 || stride < 1
      || (unsigned)x_dtype > 1 || (unsigned)offset_dtype > 1
      || (unsigned)mask_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Strides os{o_b, o_c, o_h, o_w}, ms{m_b, m_c, m_h, m_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = x_dtype == 0
      ? launch<float>(x, offset, mask, cols, B, Cin, H, W, Ho, Wo, stride, os,
                      ms, offset_dtype == 1, mask_dtype == 1, s)
      : launch<__nv_bfloat16>(x, offset, mask, cols, B, Cin, H, W, Ho, Wo,
                              stride, os, ms, offset_dtype == 1,
                              mask_dtype == 1, s);
  return (int)e;
}

}  // extern "C"
