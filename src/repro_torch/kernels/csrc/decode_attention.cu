// Decode attention for Hopper (sm_90a): one query token per (batch row,
// KV head) against that row's KV cache.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// src/repro/kernels/decode_attention.py (launched by
// `decode_attention_folded`, reached through `repro.kernels.ops
// .decode_attention`).  Same function: the G = Hq/Hkv query heads of one
// KV head are the rows of a (G, D) query block; a key at index kpos
// counts when kpos < length, kpos < T and, with a window,
// length - kpos <= window; optional soft-cap cap*tanh(s/cap); q*scale in
// fp32; online softmax with running max, sum and accumulator in fp32;
// output acc / max(l, 1e-30) in q's dtype.  A row with length <= 0 reads
// no key and writes exactly 0.
//
// Beyond the TPU kernel: an optional per-key position array (B, T).  A
// local-attention layer's cache is a ring indexed by position mod T,
// so once it wraps a key's index is not its position, and a ragged
// prefill leaves position -1 on entries it wrote past its real tokens.
// With positions, the key at index t counts when its stored position
// pos satisfies 0 <= pos < length (the query sits at length - 1) and,
// with a window, length - pos <= window: the mask of the model's plain
// attention paths, exact on a wrapped ring.  All T entries are then
// visited, and only the keys that count are read.
//
// What bounds it: the bytes of K and V.  Each cached key and value is
// read once and used for G (4 on Qwen3-8B) dot products, so a call does
// about 2 flops per byte read — far under the card's ~295 flops/byte
// ridge — and its least time is (bytes of K/V that the lengths cover)
// over the memory rate.
//
// What the design does about it:
//   * K and V are read in the model's (B, T, Hkv, D) layout through
//     strides, so no folded copy of the cache is ever made (folding, as
//     the TPU wrapper does, would copy both caches of every layer at
//     every step);
//   * tiles stop at the row's length (and start at length - window), so
//     a short row reads only its own keys;
//   * every thread issues 16-byte loads, all of a tile's loads before
//     the first use, into fp32 tiles in shared memory;
//   * the G query rows of a KV head share each K/V tile, so the cache is
//     read once per KV head, not once per query head.
// One block per (KV head, batch row): B*Hkv blocks.  At the serving
// shapes (B = 8, Hkv = 8) that is 64 blocks on 132 SMs, and one call
// moves ~2 MB, so the call is bound by its launch, not by bandwidth;
// splitting T across blocks (split-K) and TMA/wgmma pipelines are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // keys per tile: one key per lane
constexpr int kMaxG = 16;       // query rows per KV head
constexpr int kMaxDC = 2;       // head dim <= kThreads * kMaxDC
constexpr int kRowsPerWarp = kMaxG / kWarps;
constexpr float kNegInf = -1.0e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  int T, G, D;
  long long q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  float scale;
  int window;
  float cap;
  const int* kpos;   // (B, T) stored key positions, or null: index
  long long kpos_sb;
};

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int G, int D) {
  // q [G][D], K tile [kTile][D+1] (padded: conflict-free column reads),
  // V tile [kTile][D], p [G][kTile], rescale [G], row sums [G], and
  // the tile's key mask [kTile]
  return sizeof(float) *
             (size_t(G) * D + size_t(kTile) * (D + 1) + size_t(kTile) * D +
              size_t(G) * kTile + 2 * size_t(G)) +
         sizeof(int) * kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int G = p.G, D = p.D, KS = D + 1;
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kTile * KS;
  float* p_s = v_s + kTile * D;
  float* c_s = p_s + G * kTile;
  float* l_s = c_s + G;
  int* ok_s = reinterpret_cast<int*>(l_s + G);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * G * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.out) + b * p.o_sb + (long long)h * G * p.o_sh;

  const int length = p.lengths[b];
  const int* kpos = p.kpos ? p.kpos + b * p.kpos_sb : nullptr;
  // by index, only [length - window, length) can count; with positions
  // (a ring) any index can
  const int kend = kpos ? p.T : min(length, p.T);
  int kbeg = (!kpos && p.window > 0) ? max(0, length - p.window) : 0;
  kbeg = (kbeg / kTile) * kTile;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(q[g * p.q_sh + d]) * p.scale;
  }

  float acc[kMaxG][kMaxDC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < kMaxDC; ++c) acc[g][c] = 0.f;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }

  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  const int nvec = kTile * D / kVec;
  for (int t0 = kbeg; t0 < kend; t0 += kTile) {
    // ---- which keys of the tile count ----------------------------------
    if (tid < kTile) {
      const int t = t0 + tid;
      bool ok = t < kend;
      const int pos = (ok && kpos) ? kpos[t] : t;
      ok = ok && pos >= 0 && pos < length &&
           (p.window <= 0 || length - pos <= p.window);
      ok_s[tid] = ok;
    }
    __syncthreads();
    // ---- K/V tile -> fp32 shared memory (keys that do not count: 0) ----
    for (int i = tid; i < nvec; i += kThreads) {
      const int e0 = i * kVec, j = e0 / D, d = e0 - j * D;
      const int t = t0 + j;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (ok_s[j]) {
        kr = *reinterpret_cast<const uint4*>(k + t * p.k_st + d);
        vr = *reinterpret_cast<const uint4*>(v + t * p.v_st + d);
      }
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[j * KS + d + e] = to_f32(ke[e]);
        v_s[j * D + d + e] = to_f32(ve[e]);
      }
    }
    __syncthreads();

    // ---- scores s[g][j] = (q*scale) . k_j, soft-cap, mask ---------------
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile;
      const float* qr = q_s + g * D;
      const float* kr = k_s + j * KS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if (p.cap > 0.f) s = p.cap * tanhf(s / p.cap);
      p_s[i] = ok_s[j] ? s : kNegInf;
    }
    __syncthreads();

    // ---- online softmax: one warp per query row, one lane per key ------
    const bool valid = ok_s[lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = warp + r * kWarps;
      if (g < G) {
        const float s = p_s[g * kTile + lane];
        const float m_new = fmaxf(m_run[r], warp_max(s));
        const float pj = valid ? expf(s - m_new) : 0.f;
        const float corr = expf(m_run[r] - m_new);
        l_run[r] = l_run[r] * corr + warp_sum(pj);
        m_run[r] = m_new;
        p_s[g * kTile + lane] = pj;
        if (lane == 0) c_s[g] = corr;
      }
    }
    __syncthreads();

    // ---- acc[g][d] = acc * corr + sum_j p[g][j] * v[j][d] ---------------
#pragma unroll
    for (int c = 0; c < kMaxDC; ++c) {
      const int d = tid + c * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][c] *= c_s[g];
        for (int j = 0; j < kTile; ++j) {
          const float vv = v_s[j * D + d];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][c] = fmaf(p_s[g * kTile + j], vv, acc[g][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int g = warp + r * kWarps;
    if (g < G && lane == 0) l_s[g] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kMaxDC; ++c) {
    const int d = tid + c * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) o[g * p.o_sh + d] = from_f32<T>(acc[g][c] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
int launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.G, p.D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  decode_attention_kernel<T><<<dim3(Hkv, B), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/out: (B, 1, Hq, D), k/v: (B, T,
// Hkv, D), last dim contiguous, other strides in elements.  lengths:
// int32 (B,).  kpos: int32 (B, T) with row stride kpos_sb and a
// contiguous last dim, or null (a key's position is its index).  Returns
// the cudaError_t of the launch (0 = success).
int decode_attention(int dtype, const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int T, int Hkv,
                     int G, int D, long long q_sb, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     long long o_sb, long long o_sh, float scale, int window,
                     float cap, const int* kpos, long long kpos_sb,
                     void* stream) {
  if (G < 1 || G > kMaxG || D < 1 || D > kThreads * kMaxDC)
    return int(cudaErrorInvalidValue);
  Params p{q, k, v, lengths, out, T, G, D, q_sb, q_sh, k_sb, k_st, k_sh,
           v_sb, v_st, v_sh, o_sb, o_sh, scale, window, cap, kpos,
           kpos_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, Hkv, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, Hkv, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
