// FlashAttention forward for Hopper (sm_90a), cache-free self-attention.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (launched by
// `flash_attention_folded`, reached through `repro.kernels.ops
// .flash_attention`).  Same function: GQA folded position-major (row =
// s * G + g, mask on row / G), causal or not, sliding window
// qpos - kpos < window, soft-cap cap * tanh(s / cap), q * scale in fp32,
// online softmax with the running max, sum and accumulator in fp32,
// masked probabilities exactly 0, output acc / max(l, 1e-30) in q's
// dtype.  It also writes lse = m + log(max(l, 1e-30)) per folded row in
// fp32, (B, Hkv, S * G), for the backward (flash_attention_bwd.cu).
//
// What bounds it: operations.  A causal call does 4 * B * Hq * D flops
// per visible (query, key) pair; at the training shape (B 4, S = T 1024,
// Hq 32, Hkv 8, D 128) that is 3.4e10 flops against 84 MB of q, k, v and
// o, ~400 flops per byte, above the card's ridge.
//
// What the design does about it, in this first version: nothing fast
// yet — it is right first.  Scores and PV products are scalar fp32 FMAs
// from shared memory (exact fp32 for float32 inputs, no TF32), 64 x 64
// tiles, each of 256 threads holding a 4 x 4 block of scores and a
// 4 x (D / 16) block of the output; padded row strides keep the shared
// memory reads free of bank conflicts.  What it does keep from the TPU
// kernel: the S x T score matrix never reaches device memory, KV tiles
// above the diagonal or outside the window are never loaded, and q, k, v
// are read in the model's layout through strides (no folded copy).  There
// is no padding copy either: loads past S * G or T read 0 and are masked.
// Tensor-core products (mma.sync / wgmma), TMA and a pipelined tile ring
// are later work.
//
// One block per (query tile, b * Hkv); the diagonal's heaviest tiles are
// scheduled first.
#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // (B, S, Hq, D) contiguous
  float* lse;    // (B, Hkv, S * G)
  int S, T, Hkv, G;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal, window;
  float cap;
};

template <int D>
size_t smem_bytes() {
  // q tile, one K-then-V tile, probabilities
  return sizeof(float) * (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) +
                          size_t(kBQ) * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(Params p) {
  constexpr int DS = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // [kBQ][DS]  q * scale
  float* kv_s = q_s + kBQ * DS;    // [kBK][DS]  K, then V
  float* p_s = kv_s + kBK * DS;    // [kBQ][kPS] probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int G = p.G, SG = p.S * G;
  const int r0 = iq * kBQ;
  const Mask mask{SG, p.T, G, p.causal, p.window};

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const long long o_sh = D, o_ss = (long long)p.Hkv * G * D,
                  o_sb = (long long)p.S * o_ss;

  load_q_rows<T, D>(q_s, q, r0, SG, G, h, b, p.q_sb, p.q_ss, p.q_sh,
                    p.scale);

  // keys any row of this tile can see
  const int q_lo = r0 / G, q_hi = (min(r0 + kBQ, SG) - 1) / G;
  const int k_end = p.causal ? min(p.T, q_hi + 1) : p.T;
  const int k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;

  float acc[4][DC], m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                 // last tile's PV is done with kv_s
    load_k_rows<T, D>(kv_s, k, k0, p.T, h, b, p.k_sb, p.k_st, p.k_sh);
    __syncthreads();

    // ---- scores s[i][j] = (q*scale)_row . k_key ---------------------------
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kv_s[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // ---- soft-cap, mask, online softmax over the 16 threads of a row ------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        ok[j] = mask.visible(row, k0 + tx + 16 * j);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row16_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += pj;
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = pj;
      }
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + row16_sum(psum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                 // every thread is done reading K
    load_k_rows<T, D>(kv_s, v, k0, p.T, h, b, p.v_sb, p.v_st, p.v_sh);
    __syncthreads();

    // ---- acc[row][d] += sum_j p[row][j] * v[j][d] -------------------------
    const int jn = min(kBK, k_end - k0);
    for (int j = 0; j < jn; ++j) {
      float pr[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kv_s[j * DS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= SG) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    const long long off = row_offset(row, G, h, o_sb, o_ss, o_sh, b);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[off + tx + 16 * c] = from_f32<T>(acc[i][c] / l);
    if (tx == 0) p.lse[(long long)bh * SG + row] = m_run[i] + logf(l);
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  const int nq = (p.S * p.G + kBQ - 1) / kBQ;
  flash_fwd_kernel<T, D>
      <<<dim3(nq, B * p.Hkv), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, s);
    case 32: return launch<T, 32>(p, B, s);
    case 64: return launch<T, 64>(p, B, s);
    case 128: return launch<T, 128>(p, B, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q: (B, S, Hq, D), k/v: (B, T, Hkv,
// D), last dim contiguous, other strides in elements.  o: (B, S, Hq, D)
// contiguous; lse: fp32 (B, Hkv, S * G).  D in {16, 32, 64, 128}.
// Returns the cudaError_t of the launch (0 = success).
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, float* lse, int B, int S,
                        int T, int Hkv, int G, int D, long long q_sb,
                        long long q_ss, long long q_sh, long long k_sb,
                        long long k_st, long long k_sh, long long v_sb,
                        long long v_st, long long v_sh, float scale,
                        int causal, int window, float cap, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || G < 1)
    return int(cudaErrorInvalidValue);
  Params p{q, k, v, o, lse, S, T, Hkv, G, q_sb, q_ss, q_sh, k_sb, k_st,
           k_sh, v_sb, v_st, v_sh, scale, causal, window, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, B, D, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, B, D, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
