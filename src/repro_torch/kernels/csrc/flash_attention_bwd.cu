// FlashAttention backward for Hopper (sm_90a): the gradient of
// flash_attention.cu, FlashAttention-2 style.
//
// The JAX package has no Pallas backward: its Pallas forward cannot be
// differentiated, and it trains through XLA's gradient of its chunked
// attention.  This kernel is how the port computes that same gradient
// on the card when the forward went through flash_attention.cu.
//
// Given q, k, v, the forward's o and lse (fp32, (B, Hkv, S * G)) and dO:
//   1. delta[row] = sum_d dO[row][d] * o[row][d]      (flash_bwd_delta)
//   2. one block per (KV tile, b * Hkv) walks the query tiles that can see
//      its keys (flash_bwd_kernel); for each it recomputes
//        P  = exp(s - lse)           (0 where masked, s soft-capped),
//        dV += P^T dO,   dP = dO V^T,
//        dS = P * (dP - delta) * (1 - tanh^2(s_raw / cap)) under a cap,
//        dK += dS^T (q * scale),     dQ += scale * dS K.
//      dK and dV stay in registers and are written once; dQ rows receive a
//      contribution from every KV tile, so they are added into an fp32
//      buffer with atomicAdd (a second pass over the query tiles would
//      recompute P and dS, twice the operations; the atomics' order
//      changes from run to run, so dQ is not bit-reproducible).  The
//      caller converts the fp32 dQ to the input dtype.
// With GQA the G query heads of a KV head are rows of the same folded
// block, so their dK / dV contributions sum in the same accumulators.  The
// mask, the window, the cap and the causal tile skip are the forward's
// (flash_common.cuh).
//
// What bounds it: operations, ~2.5x the forward's (five products per
// visible pair against the forward's two).  This first version is scalar
// fp32 FMAs from shared memory (exact fp32 for float32 inputs, no TF32),
// 64-key x 64-row tiles, 256 threads each holding a 4 x 4 block of
// scores and a 4 x (D / 16) block of dK, dV and dQ.  Tensor cores and a
// pipelined tile ring are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;       // (B, S, Hq, D) contiguous, as is o
  const float* lse;       // (B, Hkv, S * G)
  const float* delta;     // (B, Hkv, S * G)
  float* dq;              // (B, S, Hq, D) contiguous fp32, zeroed
  void* dk;               // (B, T, Hkv, D) contiguous
  void* dv;
  int S, T, Hkv, G;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal, window;
  float cap;
};

// delta[bh * SG + row] = sum_d dO * o, one warp per folded row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* o, const T* dout, float* delta, int B, int S,
                int Hkv, int G, int D) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int SG = S * G;
  if (warp >= B * Hkv * SG) return;
  const int bh = warp / SG, row = warp - bh * SG;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const long long sh = D, ss = (long long)Hkv * G * D, sb = (long long)S * ss;
  const long long off = row_offset(row, G, h, sb, ss, sh, b);
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), acc);
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) delta[warp] = acc;
}

template <int D>
size_t smem_bytes() {
  // K, V, q*scale, dO tiles; P and dS tiles; lse and delta of the rows
  return sizeof(float) * (2 * size_t(kBK) * (D + 1) +
                          2 * size_t(kBQ) * (D + 1) + 2 * size_t(kBQ) * kPS +
                          2 * size_t(kBQ));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(Params p) {
  constexpr int DS = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                // [kBK][DS]
  float* v_s = k_s + kBK * DS;      // [kBK][DS]
  float* q_s = v_s + kBK * DS;      // [kBQ][DS]  q * scale
  float* do_s = q_s + kBQ * DS;     // [kBQ][DS]
  float* p_s = do_s + kBQ * DS;     // [kBQ][kPS]
  float* ds_s = p_s + kBQ * kPS;    // [kBQ][kPS]
  float* lse_s = ds_s + kBQ * kPS;  // [kBQ]
  float* dl_s = lse_s + kBQ;        // [kBQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int G = p.G, SG = p.S * G, T_ = p.T;
  const Mask mask{SG, T_, G, p.causal, p.window};
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const long long c_sh = D, c_ss = (long long)p.Hkv * G * D,
                  c_sb = (long long)p.S * c_ss;   // contiguous (B,S,Hq,D)
  const float* lse = p.lse + (long long)bh * SG;
  const float* delta = p.delta + (long long)bh * SG;

  load_k_rows<T, D>(k_s, static_cast<const T*>(p.k), k0, T_, h, b, p.k_sb,
                    p.k_st, p.k_sh);
  load_k_rows<T, D>(v_s, static_cast<const T*>(p.v), k0, T_, h, b, p.v_sb,
                    p.v_st, p.v_sh);

  // the folded rows that can see a key of this tile
  const int kmax = min(T_, k0 + kBK) - 1;
  const int r_begin = p.causal ? min(SG, k0 * G) : 0;
  const int r_end = p.window > 0 ? min(SG, (kmax + p.window) * G) : SG;
  const int r_first = (r_begin / kBQ) * kBQ;

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int r0 = r_first; r0 < r_end; r0 += kBQ) {
    __syncthreads();               // last iteration is done with the tiles
    load_q_rows<T, D>(q_s, q, r0, SG, G, h, b, p.q_sb, p.q_ss, p.q_sh,
                      p.scale);
    load_q_rows<T, D>(do_s, dout, r0, SG, G, h, b, c_sb, c_ss, c_sh, 1.f);
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool in = r0 + r < SG;
      lse_s[r] = in ? lse[r0 + r] : 0.f;
      dl_s[r] = in ? delta[r0 + r] : 0.f;
    }
    __syncthreads();

    // ---- s = (q*scale) K^T and dP = dO V^T, 4 rows x 4 keys a thread ------
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q_s[(ty + 16 * i) * DS + d];
        g[i] = do_s[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = k_s[(tx + 16 * j) * DS + d];
        vv[j] = v_s[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }

    // ---- P and dS --------------------------------------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j], t = 0.f;
        if (p.cap > 0.f) {
          t = tanhf(x / p.cap);
          x = p.cap * t;
        }
        const bool ok = mask.visible(r0 + r, k0 + c);
        const float pj = ok ? expf(x - lse_s[r]) : 0.f;
        float dsj = pj * (dp[i][j] - dl_s[r]);
        if (p.cap > 0.f) dsj *= 1.f - t * t;
        p_s[r * kPS + c] = pj;
        ds_s[r * kPS + c] = dsj;
      }
    }
    __syncthreads();

    // ---- dV += P^T dO, dK += dS^T (q*scale): 4 keys x D/16 cols a thread --
    const int rn = min(kBQ, SG - r0);
    for (int r = 0; r < rn; ++r) {
      float pr[4], sr[4], gr[DC], qr[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = p_s[r * kPS + ty + 16 * i];
        sr[i] = ds_s[r * kPS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gr[c] = do_s[r * DS + tx + 16 * c];
        qr[c] = q_s[r * DS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[i][c] = fmaf(pr[i], gr[c], dv[i][c]);
          dk[i][c] = fmaf(sr[i], qr[c], dk[i][c]);
        }
    }

    // ---- dQ += scale * dS K: 4 rows x D/16 cols a thread, atomically ----
    {
      float dq[4][DC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
      const int cn = kmax - k0 + 1;
      for (int j = 0; j < cn; ++j) {
        float sr[4], kr[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) sr[i] = ds_s[(ty + 16 * i) * kPS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) kr[c] = k_s[j * DS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) dq[i][c] = fmaf(sr[i], kr[c], dq[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row >= SG) continue;
        float* dst = p.dq + row_offset(row, G, h, c_sb, c_ss, c_sh, b);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          atomicAdd(dst + tx + 16 * c, dq[i][c] * p.scale);
      }
    }
  }

  // ---- dK, dV of this tile's keys -----------------------------------------
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
  const long long t_sh = D, t_st = (long long)p.Hkv * D,
                  t_sb = (long long)T_ * t_st;    // contiguous (B,T,Hkv,D)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= T_) continue;
    const long long off = b * t_sb + kpos * t_st + h * t_sh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_out[off + tx + 16 * c] = from_f32<T>(dk[i][c]);
      dv_out[off + tx + 16 * c] = from_f32<T>(dv[i][c]);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  const int nk = (p.T + kBK - 1) / kBK;
  flash_bwd_kernel<T, D>
      <<<dim3(nk, B * p.Hkv), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int run(const Params& p, const void* o, int B, int D, cudaStream_t s) {
  const long long rows = (long long)B * p.Hkv * p.S * p.G;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  flash_bwd_delta<T><<<unsigned(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(p.dout),
      const_cast<float*>(p.delta), B, p.S, p.Hkv, p.G, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
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
// D), last dim contiguous, other strides in elements.  o and dout:
// (B, S, Hq, D) contiguous in q's dtype; lse: fp32 (B, Hkv, S * G).
// Scratch: delta fp32 (B, Hkv, S * G); dq_acc fp32 (B, S, Hq, D), zeroed
// by the caller.  Outputs: dq_acc holds dq in fp32; dk/dv (B, T, Hkv, D)
// contiguous in q's dtype.  D in {16, 32, 64, 128}.
// Returns the first cudaError_t of the launches (0 = success).
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const float* lse, float* delta, float* dq_acc,
                        void* dk, void* dv, int B, int S,
                        int T, int Hkv, int G, int D, long long q_sb,
                        long long q_ss, long long q_sh, long long k_sb,
                        long long k_st, long long k_sh, long long v_sb,
                        long long v_st, long long v_sh, float scale,
                        int causal, int window, float cap, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || G < 1)
    return int(cudaErrorInvalidValue);
  Params p{q, k, v, dout, lse, delta, dq_acc, dk, dv, S, T, Hkv, G,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           scale, causal, window, cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(p, o, B, D, s);
  if (dtype == 1) return run<__nv_bfloat16>(p, o, B, D, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
