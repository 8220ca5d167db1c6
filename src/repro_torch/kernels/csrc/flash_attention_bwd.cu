// FlashAttention backward for Hopper (sm_90a): the gradient of
// flash_attention.cu.
//
// The JAX package has no Pallas backward: its Pallas forward cannot be
// differentiated, and it trains through XLA's gradient of its chunked
// attention.  This kernel is how the port computes that same gradient
// on the card when the forward went through flash_attention.cu.
//
// Given q, k, v, the forward's o and lse (fp32, (B, Hkv, S * G)) and dO:
//   1. delta[row] = sum_d dO[row][d] * o[row][d]      (flash_bwd_delta)
//   2. one block per (KV tile, b * Hkv) walks the query tiles that can see
//      its keys; for each it recomputes
//        P  = exp(s - lse)           (0 where masked, s soft-capped),
//        dV += P^T dO,   dP = dO V^T,
//        dS = P * (dP - delta) * (1 - tanh^2(s_raw / cap)) under a cap,
//        dK += dS^T (q * scale),     dQ += scale * dS K.
//      dK and dV stay in registers and are written once; dQ rows receive a
//      contribution from every KV tile, so they are added into an fp32
//      buffer the caller zeroed (a second pass over the query tiles would
//      recompute P and dS, twice the operations; the additions' order
//      changes from run to run, so dQ is not bit-reproducible).
// With GQA the G query heads of a KV head are rows of the same folded
// block, so their dK / dV contributions sum in the same accumulators.  The
// mask, the window, the cap and the causal tile skip are the forward's
// (flash_common.cuh).
//
// What bounds it: operations, 2.5x the forward's (five products per
// visible pair against the forward's two): 8.6e10 flops at the training
// shape, for the tensor cores.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (flash_bwd_sm90): FlashAttention-3's shape.  A block owns 128
// keys: two consumer warpgroups of 64 keys each, with K and V resident in
// swizzled shared memory, and a producer warp that streams the tiles of 64
// folded rows (q, dO, lse, delta) through a 2-stage ring with full and
// empty mbarriers; setmaxnreg moves the producer's registers to the
// consumers.  When G divides 64 a tile is 64 / G whole positions of G
// heads, one TMA box of q's and of dO's own 4-D maps; otherwise (G = 3,
// ...) folded rows mix positions and heads at the tile's edge and the
// warp copies them by 16-byte cp.async (one warp's cp.async loop, with
// its address arithmetic at 24 registers, cannot keep up with the
// consumers at the training shape; TMA can).  Each consumer computes the
// transposed products, so that every operand lands where the next product
// needs it: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16 from shared
// memory), P^T and dS^T on the accumulator fragments, dV += P^T dO and
// dK += dS^T Q with P^T and dS^T as bf16 register operands and dO / Q
// read through the transpose bit.
// dS^T goes to shared memory as bf16 (two buffers, so one barrier a tile
// suffices), and dQ = dS K runs with dQ's D columns split across the two
// warpgroups; each row tile of dQ is added into the fp32 buffer straight
// from the accumulators by 16-byte vector atomics (red.global.add.v4.f32,
// one per 4 columns), in place of a scalar atomic per element.
// flash_attention_dq_convert then writes dq in bf16.  Blocks are
// scheduled longest first (causal: key tile 0 sees every row).
//
// float32 (flash_bwd_kernel): exact fp32, no TF32 — scalar FMAs from
// shared memory, 64-key x 64-row tiles (32 x 32 at D 256, so that they
// fit 227 KB), dQ by atomicAdd; dq_acc is the result.  At D 256 it also
// takes bf16 (read as bf16, summed in fp32, dQ converted by
// flash_attention_dq_convert): the wgmma kernel's dK and dV accumulators
// at 64 keys x 256 would not fit a thread's registers.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

// BQ folded rows x BK keys a tile: 64 x 64, or 32 x 32 at D 256, where
// the 64 x 64 tiles' shared memory (297 KB) would not fit a block
template <int D>
constexpr int bwd_tile() {
  return D > 128 ? 32 : 64;
}

template <int D, int BQ, int BK>
size_t smem_bytes() {
  // K, V, q*scale, dO tiles; P and dS tiles; lse and delta of the rows
  return sizeof(float) * (2 * size_t(BK) * (D + 1) + 2 * size_t(BQ) * (D + 1) +
                          2 * size_t(BQ) * (BK + 1) + 2 * size_t(BQ));
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(Params p) {
  constexpr int DS = D + 1, DC = D / 16, PS = BK + 1;
  constexpr int RQ = BQ / 16, RK = BK / 16;   // rows, keys a thread
  extern __shared__ float smem[];
  float* k_s = smem;                // [BK][DS]
  float* v_s = k_s + BK * DS;       // [BK][DS]
  float* q_s = v_s + BK * DS;       // [BQ][DS]  q * scale
  float* do_s = q_s + BQ * DS;      // [BQ][DS]
  float* p_s = do_s + BQ * DS;      // [BQ][PS]
  float* ds_s = p_s + BQ * PS;      // [BQ][PS]
  float* lse_s = ds_s + BQ * PS;    // [BQ]
  float* dl_s = lse_s + BQ;         // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int G = p.G, SG = p.S * G, T_ = p.T;
  const Mask mask{SG, T_, G, p.causal, p.window};
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const long long c_sh = D, c_ss = (long long)p.Hkv * G * D,
                  c_sb = (long long)p.S * c_ss;   // contiguous (B,S,Hq,D)
  const float* lse = p.lse + (long long)bh * SG;
  const float* delta = p.delta + (long long)bh * SG;

  load_k_rows<T, D, BK>(k_s, static_cast<const T*>(p.k), k0, T_, h, b,
                        p.k_sb, p.k_st, p.k_sh);
  load_k_rows<T, D, BK>(v_s, static_cast<const T*>(p.v), k0, T_, h, b,
                        p.v_sb, p.v_st, p.v_sh);

  // the folded rows that can see a key of this tile
  const int kmax = min(T_, k0 + BK) - 1;
  const int r_begin = p.causal ? min(SG, k0 * G) : 0;
  const int r_end = p.window > 0 ? min(SG, (kmax + p.window) * G) : SG;
  const int r_first = (r_begin / BQ) * BQ;

  float dk[RK][DC], dv[RK][DC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int r0 = r_first; r0 < r_end; r0 += BQ) {
    __syncthreads();               // last iteration is done with the tiles
    load_q_rows<T, D, BQ>(q_s, q, r0, SG, G, h, b, p.q_sb, p.q_ss, p.q_sh,
                          p.scale);
    load_q_rows<T, D, BQ>(do_s, dout, r0, SG, G, h, b, c_sb, c_ss, c_sh,
                          1.f);
    for (int r = tid; r < BQ; r += kThreads) {
      const bool in = r0 + r < SG;
      lse_s[r] = in ? lse[r0 + r] : 0.f;
      dl_s[r] = in ? delta[r0 + r] : 0.f;
    }
    __syncthreads();

    // ---- s = (q*scale) K^T and dP = dO V^T, RQ rows x RK keys a thread ---
    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[RQ], g[RQ], kk[RK], vv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = q_s[(ty + 16 * i) * DS + d];
        g[i] = do_s[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kk[j] = k_s[(tx + 16 * j) * DS + d];
        vv[j] = v_s[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }

    // ---- P and dS --------------------------------------------------------
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
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
        p_s[r * PS + c] = pj;
        ds_s[r * PS + c] = dsj;
      }
    }
    __syncthreads();

    // ---- dV += P^T dO, dK += dS^T (q*scale): RK keys x D/16 cols a thread -
    const int rn = min(BQ, SG - r0);
    for (int r = 0; r < rn; ++r) {
      float pr[RK], sr[RK], gr[DC], qr[DC];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pr[i] = p_s[r * PS + ty + 16 * i];
        sr[i] = ds_s[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gr[c] = do_s[r * DS + tx + 16 * c];
        qr[c] = q_s[r * DS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[i][c] = fmaf(pr[i], gr[c], dv[i][c]);
          dk[i][c] = fmaf(sr[i], qr[c], dk[i][c]);
        }
    }

    // ---- dQ += scale * dS K: RQ rows x D/16 cols a thread, atomically ----
    {
      float dq[RQ][DC];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
      const int cn = kmax - k0 + 1;
      for (int j = 0; j < cn; ++j) {
        float sr[RQ], kr[DC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) sr[i] = ds_s[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) kr[c] = k_s[j * DS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) dq[i][c] = fmaf(sr[i], kr[c], dq[i][c]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
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
  for (int i = 0; i < RK; ++i) {
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
int launch_scalar(const Params& p, int B, cudaStream_t stream) {
  constexpr int BQ = bwd_tile<D>(), BK = bwd_tile<D>();
  const size_t smem = smem_bytes<D, BQ, BK>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int nk = (p.T + BK - 1) / BK;
  flash_bwd_kernel<T, D, BQ, BK>
      <<<dim3(nk, B * p.Hkv), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, a row-tile ring and vector atomics for dQ
// ---------------------------------------------------------------------------
namespace hop {

using namespace flash::sm90;

constexpr int kKeys = 128;      // keys a block (64 a consumer warpgroup)
constexpr int kRows = 64;       // folded rows a tile
constexpr int kStages = 2;
constexpr int kBlock = 3 * kWarpgroup;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr uint32_t kKV = kKeys * D * 2;      // K or V
  static constexpr uint32_t kQ = kRows * D * 2;       // a q or dO tile
  static constexpr uint32_t kDS = kKeys * kRows * 2;  // dS^T, bf16
  static constexpr uint32_t k = 0, v = kKV;
  __host__ __device__ static constexpr uint32_t q(int s) {
    return 2 * kKV + s * kQ;
  }
  __host__ __device__ static constexpr uint32_t dout(int s) {
    return 2 * kKV + (kStages + s) * kQ;
  }
  __host__ __device__ static constexpr uint32_t ds(int i) {
    return 2 * kKV + 2 * kStages * kQ + i * kDS;
  }
  static constexpr uint32_t lse =
      2 * kKV + 2 * kStages * kQ + 2 * kDS;              // [kStages][kRows]
  static constexpr uint32_t delta = lse + kStages * kRows * 4;
  static constexpr uint32_t bars = delta + kStages * kRows * 4;
  static constexpr uint32_t bytes = bars + (1 + 2 * kStages) * 8 + 1024;
};

// P^T and dS^T of one tile on a warpgroup's m64n64 fragments of S^T
// (rows = keys, columns = folded rows) and dP^T, in place: P^T = exp(s -
// lse) (lse2 = lse * log2(e)), 0 where masked (kMasked), dS^T = P^T (dP^T -
// delta), times 1 - tanh^2 under a cap (kCapped).
template <bool kMasked, bool kCapped>
__device__ __forceinline__ void grad_tile(Frag<kRows>& sT, Frag<kRows>& dpT,
                                          const float* lse2, const float* dlt,
                                          const Mask& mask, int rt0,
                                          const int (&key)[2], int col0,
                                          float scale, float cap) {
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + col0 + (e & 1);
      float x = sT.x[4 * j + e], tt = 0.f;
      if (kCapped) {
        tt = tanhf(x * scale / cap);
        x = cap * tt * kLog2e;
      } else {
        x *= sl2;
      }
      float pr = exp2_approx(x - lse2[c]);
      if (kMasked && !mask.visible(rt0 + c, key[e >> 1])) pr = 0.f;
      float dsv = pr * (dpT.x[4 * j + e] - dlt[c]);
      if (kCapped) dsv *= 1.f - tt * tt;
      sT.x[4 * j + e] = pr;
      dpT.x[4 * j + e] = dsv;
    }
}

template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_bwd_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap domap, Params p,
               int rows_by_tma) {
  using Tl = Tile<D>;
  using L = Smem<D>;
  constexpr int W = Tl::W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* lse_s = reinterpret_cast<float*>(sm + L::lse);
  float* dl_s = reinterpret_cast<float*>(sm + L::delta);

  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  // the key tile is the slowest grid dimension: under a causal mask tile 0
  // sees every row, so the longest blocks start first
  const int k0 = blockIdx.y * kKeys;
  const int bh = blockIdx.x, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int G = p.G, SG = p.S * G, T_ = p.T;
  const long long c_sh = D, c_ss = (long long)p.Hkv * G * D,
                  c_sb = (long long)p.S * c_ss;   // contiguous (B,S,Hq,D)

  // the folded rows that can see a key of this block (as the fp32 kernel)
  const int kmax = min(T_, k0 + kKeys) - 1;
  const int r_begin = p.causal ? min(SG, k0 * G) : 0;
  const int r_end = p.window > 0 ? min(SG, (kmax + p.window) * G) : SG;
  const int r_first = (r_begin / kRows) * kRows;
  const int n_tiles = max(0, (r_end - r_first + kRows - 1) / kRows);

  if (tid == 0) {
    mbar_init(kv_full, 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 copies K, V, then the row tiles ---------------
    reg_dealloc<24>();
    if (tid >= 32) return;
    const int lane = tid;
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
    for (int i = lane; i < kKeys * (D / 8); i += 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int kpos = k0 + r;
      const bool ok = kpos < T_;
      const uint32_t off = Tl::offset(kKeys, r, c);
      cp_async16(sm + L::k + off,
                 ok ? k + b * p.k_sb + kpos * p.k_st + h * p.k_sh + c : k, ok);
      cp_async16(sm + L::v + off,
                 ok ? v + b * p.v_sb + kpos * p.v_st + h * p.v_sh + c : v, ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
    mbar_arrive(kv_full);

    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout);
    const float* lse = p.lse + (long long)bh * SG;
    const float* delta = p.delta + (long long)bh * SG;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int rt0 = r_first + it * kRows;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      if (!rows_by_tma) {
        load_rows_async<D, kRows>(sm + L::q(s), q, rt0, SG, G, h, b, p.q_sb,
                                  p.q_ss, p.q_sh, lane, 32);
        load_rows_async<D, kRows>(sm + L::dout(s), dout, rt0, SG, G, h, b,
                                  c_sb, c_ss, c_sh, lane, 32);
        cp_async_commit();
      }
      for (int r = lane; r < kRows; r += 32) {
        const bool ok = rt0 + r < SG;
        lse_s[s * kRows + r] = ok ? lse[rt0 + r] * kLog2e : 0.f;
        dl_s[s * kRows + r] = ok ? delta[rt0 + r] : 0.f;
      }
      if (!rows_by_tma) {
        cp_async_wait_all();
        fence_proxy_async();
        mbar_arrive(&full[s]);
      } else if (lane != 0) {
        mbar_arrive(&full[s]);
      } else {
        // G divides kRows: the tile is kRows / G positions of G heads
        mbar_expect_tx(&full[s], 2 * L::kQ);
        for (int c = 0; c < Tl::NH; ++c) {
          tma_load_4d(sm + L::q(s) + c * kRows * W, &qmap, &full[s],
                      c * (W / 2), h * G, rt0 / G, b);
          tma_load_4d(sm + L::dout(s) + c * kRows * W, &domap, &full[s],
                      c * (W / 2), h * G, rt0 / G, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns keys k0 + 64w .. k0 + 64w + 63 -------
  reg_alloc<240>();
  const int w = wg - 1, t = tid % kWarpgroup;
  const int warp = t / 32, lane = t % 32;
  const int kw0 = k0 + 64 * w;
  const int keya = kw0 + 16 * warp + lane / 4, keyb = keya + 8;
  const int col0 = 2 * (lane % 4);
  const Mask mask{SG, T_, G, p.causal, p.window};
  const bool capped = p.cap > 0.f;
  const int key[2] = {keya, keyb};

  const uint32_t k_addr = smem_u32(sm + L::k);
  const uint32_t v_addr = smem_u32(sm + L::v);
  // dQ's columns w * D/2 .. of the K tile, as an MN-major B operand
  constexpr int kHalf = D / 2;
  const uint32_t kq_addr = k_addr + (w * kHalf / (W / 2)) * kKeys * W +
                           (w * kHalf % (W / 2)) * 2;

  Frag<D> dk, dv;
  dk.zero();
  dv.zero();
  Frag<kRows> sT, dpT;
  Frag<kHalf> dq;
  uint32_t pa[kRows / 4], da[kRows / 4];
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int rt0 = r_first + it * kRows;
    const uint32_t q_addr = smem_u32(sm + L::q(s));
    const uint32_t do_addr = smem_u32(sm + L::dout(s));
    uint8_t* ds_buf = sm + L::ds(it & 1);

    // ---- S^T = K Q^T, dP^T = V dO^T ------------------------------------
    mbar_wait(&full[s], par);
    sT.fence();
    dpT.fence();
    wg_fence();
#pragma unroll
    for (int c = 0; c < Tl::NH; ++c)
#pragma unroll
      for (int kk = 0; kk < Tl::kKSteps; ++kk) {
        const uint32_t ko = c * kKeys * W + 64 * w * W + kk * 32;
        const uint32_t qo = c * kRows * W + kk * 32;
        wgmma_ss<0, 0>(sT, make_desc(k_addr + ko, 16, 8 * W, Tl::kLayout),
                       make_desc(q_addr + qo, 16, 8 * W, Tl::kLayout),
                       c | kk);
        wgmma_ss<0, 0>(dpT, make_desc(v_addr + ko, 16, 8 * W, Tl::kLayout),
                       make_desc(do_addr + qo, 16, 8 * W, Tl::kLayout),
                       c | kk);
      }
    wg_commit();
    wg_wait<0>();
    sT.fence();
    dpT.fence();

    // ---- P^T and dS^T on the fragments ---------------------------------
    const bool masked =
        rt0 + kRows > SG || kw0 + 64 > T_ ||
        (p.causal && kw0 + 63 > rt0 / G) ||
        (p.window > 0 && (min(rt0 + kRows, SG) - 1) / G - kw0 >= p.window);
    const float* lse2 = lse_s + s * kRows;
    const float* dlt = dl_s + s * kRows;
    if (capped) {
      if (masked)
        grad_tile<true, true>(sT, dpT, lse2, dlt, mask, rt0, key, col0,
                              p.scale, p.cap);
      else
        grad_tile<false, true>(sT, dpT, lse2, dlt, mask, rt0, key, col0,
                               p.scale, p.cap);
    } else {
      if (masked)
        grad_tile<true, false>(sT, dpT, lse2, dlt, mask, rt0, key, col0,
                               p.scale, p.cap);
      else
        grad_tile<false, false>(sT, dpT, lse2, dlt, mask, rt0, key, col0,
                                p.scale, p.cap);
    }
    to_a_operand(sT, pa);
    to_a_operand(dpT, da);

    // ---- dV += P^T dO, dK += dS^T Q ------------------------------------
    dv.fence();
    dk.fence();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs<1>(dv, &pa[4 * kk],
                  make_desc(do_addr + kk * 16 * W, kRows * W, 8 * W,
                            Tl::kLayout), 1);
      wgmma_rs<1>(dk, &da[4 * kk],
                  make_desc(q_addr + kk * 16 * W, kRows * W, 8 * W,
                            Tl::kLayout), 1);
    }
    wg_commit();

    // ---- dS^T to shared memory as [key][row], 128-byte rows, swizzled --
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = 64 * w + 16 * warp + lane / 4 + 8 * r;
        const uint32_t off = uint32_t(key * 128 + (8 * j + col0) * 2);
        *reinterpret_cast<uint32_t*>(ds_buf + Tile<64>::swizzle(off)) =
            da[2 * j + r];
      }
    fence_proxy_async();
    wg_wait<0>();
    dv.fence();
    dk.fence();
    fence_regs(pa);
    fence_regs(da);
    named_bar_sync(1, 2 * kWarpgroup);   // dS^T of all 128 keys is in

    // ---- dQ[:, w half] = dS K[:, w half] --------------------------------
    const uint32_t ds_addr = smem_u32(ds_buf);
    dq.zero();
    dq.fence();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_ss<1, 1>(dq, make_desc(ds_addr + kk * 16 * 128, 64 * 128, 1024, 1),
                     make_desc(kq_addr + kk * 16 * W, kKeys * W, 8 * W,
                               Tl::kLayout), 1);
    wg_commit();
    wg_wait<0>();
    dq.fence();
    mbar_arrive(&empty[s]);            // q, dO, lse, delta of stage s

    // ---- dQ (times scale) into the fp32 buffer: 16-byte vector atomics.
    // Lanes 2i and 2i + 1 trade a column pair, so that the even lane adds
    // 4 neighbouring columns of its first row and the odd lane of its
    // second.
    const bool odd = lane & 1;
    const int row = rt0 + 16 * warp + lane / 4 + (odd ? 8 : 0);
    float* dst = p.dq + row_offset(min(row, SG - 1), G, h, c_sb, c_ss, c_sh,
                                   b) + w * kHalf + 4 * ((lane % 4) >> 1);
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const float* x = dq.x + 4 * j;
      const float y0 = __shfl_xor_sync(0xffffffffu, odd ? x[0] : x[2], 1);
      const float y1 = __shfl_xor_sync(0xffffffffu, odd ? x[1] : x[3], 1);
      const float4 add = odd ? make_float4(y0, y1, x[2], x[3])
                             : make_float4(x[0], x[1], y0, y1);
      if (row < SG)
        atomicAdd(reinterpret_cast<float4*>(dst + 8 * j),
                  make_float4(add.x * p.scale, add.y * p.scale,
                              add.z * p.scale, add.w * p.scale));
    }
  }

  // ---- dK (times scale), dV of this warpgroup's keys -------------------
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv);
  const long long t_st = (long long)p.Hkv * D,
                  t_sb = (long long)T_ * t_st;    // contiguous (B,T,Hkv,D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = r ? keyb : keya;
    if (kpos >= T_) continue;
    const long long off = b * t_sb + kpos * t_st + (long long)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk_out + off + 8 * j + col0) =
          pack_bf16(dk.x[4 * j + 2 * r] * p.scale,
                    dk.x[4 * j + 2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + off + 8 * j + col0) =
          pack_bf16(dv.x[4 * j + 2 * r], dv.x[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  // q and dO tiles by TMA when a tile is whole positions (G | kRows),
  // else by cp.async
  CUtensorMap qmap = {}, domap = {};
  const int by_tma = kRows % p.G == 0;
  if (by_tma) {
    const int Hq = p.Hkv * p.G;
    int e = tensor_map<D>(&qmap, p.q, B, p.S, Hq, p.q_sb, p.q_ss, p.q_sh,
                          p.G, kRows / p.G);
    if (e) return e;
    e = tensor_map<D>(&domap, p.dout, B, p.S, Hq, (long long)p.S * Hq * D,
                      (long long)Hq * D, D, p.G, kRows / p.G);
    if (e) return e;
  }
  const int smem = int(Smem<D>::bytes);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const int nk = (p.T + kKeys - 1) / kKeys;
  flash_bwd_sm90<D><<<dim3(B * p.Hkv, nk), kBlock, smem, stream>>>(
      qmap, domap, p, by_tma);
  return int(cudaGetLastError());
}

// dq = dq_acc in bf16, four values a thread-step (n % 4 == 0)
__global__ void dq_to_bf16(const float4* src, uint2* dst, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 x = src[i];
    dst[i] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

}  // namespace hop

template <int D>
int launch_one(const Params& p, int B, bool bf16, cudaStream_t s) {
  return bf16 ? hop::launch<D>(p, B, s) : launch_scalar<float, D>(p, B, s);
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
  constexpr bool kBf16 = sizeof(T) == 2;
  switch (D) {
    case 16: return launch_one<16>(p, B, kBf16, s);
    case 32: return launch_one<32>(p, B, kBf16, s);
    case 64: return launch_one<64>(p, B, kBf16, s);
    case 128: return launch_one<128>(p, B, kBf16, s);
    // both dtypes on the scalar kernel: the wgmma kernel's dK and dV at
    // 64 keys x 256 would take 256 registers a thread
    case 256: return launch_scalar<T, 256>(p, B, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (the wgmma kernel;
// the scalar kernel at D 256).
// q: (B, S, Hq, D), k/v: (B, T, Hkv, D), last dim contiguous, other
// strides in elements; for bfloat16 every pointer and byte stride is a
// multiple of 16 (the wrapper checks).  o and dout: (B, S, Hq, D)
// contiguous in q's dtype; lse: fp32 (B, Hkv, S * G).  Scratch: delta
// fp32 (B, Hkv, S * G); dq_acc fp32 (B, S, Hq, D), zeroed by the caller.
// Outputs: dq_acc holds dq in fp32 (flash_attention_dq_convert gives it in
// bf16); dk/dv (B, T, Hkv, D) contiguous in q's dtype.  D in {16, 32, 64,
// 128, 256}.  Returns the first cudaError_t of the launches (0 = success).
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

// dq (bf16) = dq_acc (fp32), n elements, n % 4 == 0, both 16-byte aligned.
int flash_attention_dq_convert(const float* dq_acc, void* dq, long long n,
                               void* stream) {
  if (n < 4 || n % 4) return int(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  const long long want = (n4 + 255) / 256;
  const int blocks = int(want < 132 * 16 ? want : 132 * 16);
  hop::dq_to_bf16<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), n4);
  return int(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
