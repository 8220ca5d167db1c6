// Shared by flash_attention.cu and flash_attention_bwd.cu: the folded
// row layout, the mask and the dtype conversions, so that the backward
// masks and soft-caps exactly as the forward did.
//
// Layout: q (B, S, Hq, D), k/v (B, T, Hkv, D) in the model's layout, read
// through strides (last dim contiguous).  The G = Hq / Hkv query heads of
// KV head h are folded position-major: row = s * G + g reads
// q[b, s, h * G + g, :], so the rows of one (b, h) are S * G rows, and the
// causal / window mask uses the position row / G.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr float kNegInf = -1.0e30f;
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kBQ = 64;           // folded query rows per tile
constexpr int kBK = 64;           // keys per tile
constexpr int kPS = kBK + 1;      // padded row stride of a (kBQ, kBK) tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Mask {
  int SG, T, G, causal, window;

  // Does a query at position qpos (of a folded row < SG) see key kpos?
  __device__ __forceinline__ bool sees(int qpos, int kpos) const {
    if (kpos >= T) return false;
    if (causal && kpos > qpos) return false;
    if (window > 0 && qpos - kpos >= window) return false;
    return true;
  }
  // Does folded row `row` see key `kpos`?
  __device__ __forceinline__ bool visible(int row, int kpos) const {
    return row < SG && sees(row / G, kpos);
  }
};

// Element offset of folded row `row` of KV head h in a (B, S, Hq, D)
// tensor at batch row b (last dim contiguous).
__device__ __forceinline__ long long row_offset(int row, int G, int h,
                                                long long sb, long long ss,
                                                long long sh, int b) {
  const int s = row / G, g = row - s * G;
  return b * sb + s * ss + (long long)(h * G + g) * sh;
}

// Copy rows [r0, r0 + R) of (b, h) into a padded fp32 tile (row stride
// D + 1), times `mul`; rows past SG are 0.  Neighbouring threads read
// neighbouring elements of a row.
template <typename T, int D, int R = kBQ>
__device__ __forceinline__ void load_q_rows(float* dst, const T* src,
                                            int r0, int SG, int G, int h,
                                            int b, long long sb,
                                            long long ss, long long sh,
                                            float mul) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    float x = 0.f;
    if (row < SG)
      x = to_f32(src[row_offset(row, G, h, sb, ss, sh, b) + d]) * mul;
    dst[r * (D + 1) + d] = x;
  }
}

// Copy keys [k0, k0 + R) of (b, h) of a (B, T, Hkv, D) tensor into a
// padded fp32 tile; keys past T are 0.
template <typename T, int D, int R = kBK>
__device__ __forceinline__ void load_k_rows(float* dst, const T* src,
                                            int k0, int T_, int h, int b,
                                            long long sb, long long st,
                                            long long sh) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const int kpos = k0 + j;
    float x = 0.f;
    if (kpos < T_) x = to_f32(src[b * sb + kpos * st + h * sh + d]);
    dst[j * (D + 1) + d] = x;
  }
}

__device__ __forceinline__ float row16_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row16_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace flash
