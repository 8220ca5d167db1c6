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
// o, ~400 flops per byte, above the card's ridge, so only the tensor
// cores' 989 TFLOP/s (bf16, through wgmma) can approach the bound.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (flash_fwd_sm90, the training path): FlashAttention-3's shape.
// One block per (128 folded query rows, b * Hkv), heaviest causal tiles
// first, three warpgroups.  One producer thread issues TMA loads of K and
// V tiles of 128 keys (64 at D 256, so that Q and the ring fit 227 KB;
// 4-D tensor maps over k's and v's own strides, so no folded or padded
// copy; keys past T read 0) into a 2-stage ring with
// full and empty mbarriers per stage, K and V on separate barriers so the
// scores start before V lands; setmaxnreg gives its registers to the two
// consumer warpgroups, each owning 64 query rows.  Operands stay bf16 in
// swizzled shared memory (flash_sm90.cuh), which wgmma reads directly: S =
// Q K^T is m64n128k16 with both operands in shared memory; the online
// softmax runs on the accumulator fragments (exp2 with scale * log2(e)
// folded in, the row max and sum across the 4 threads of a row, the mask
// only on tiles that cross the diagonal, the window's edge, T or S * G);
// P goes to bf16 in registers and O += P V is m64nDk16 (up to m64n256)
// with P as the register operand and V read through the transpose bit.  Q is loaded
// once by 16-byte cp.async, since its folded rows mix positions and heads.
//
// float32 (flash_fwd_kernel): exact fp32, no TF32 — scalar FMAs from
// shared memory, 64 x 64 tiles (145 KB of shared memory at D 256), 256
// threads each holding a 4 x 4 block of scores and a 4 x (D / 16) block
// of the output.  A bf16 input never
// reaches it.
//
// Both keep what the TPU kernel keeps: the S x T score matrix never
// reaches device memory, KV tiles above the diagonal or before the
// window's first key are never loaded (k_begin, k_end), and q, k, v are
// read in the model's layout through strides.  The mask is
// flash_common.cuh's Mask for both.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

template <int D>
int launch_scalar(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  const int nq = (p.S * p.G + kBQ - 1) / kBQ;
  flash_fwd_kernel<float, D>
      <<<dim3(nq, B * p.Hkv), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA and an mbarrier ring
// ---------------------------------------------------------------------------
namespace hop {

using namespace flash::sm90;

constexpr int kRows = 128;      // folded query rows a block
constexpr int kStages = 2;
constexpr int kBlock = 3 * kWarpgroup;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// keys a tile: 128, or 64 at D 256, where Q (64 KB) and a 2-stage ring of
// 128-key K and V tiles (256 KB) would not fit a block's 227 KB; the
// 64-key ring is 128 KB, and O (m64n256, 128 fp32 registers a thread),
// S (m64n64, 32) and P (16) fit the consumers' 240 registers
template <int D>
constexpr int keys_for() {
  return D > 128 ? 64 : 128;
}

template <int D>
struct Smem {
  static constexpr int kKeys = keys_for<D>();
  static constexpr uint32_t kQ = kRows * D * 2;
  static constexpr uint32_t kKV = kKeys * D * 2;
  static constexpr uint32_t q = 0;
  __host__ __device__ static constexpr uint32_t k(int s) {
    return kQ + 2 * s * kKV;
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return kQ + (2 * s + 1) * kKV;
  }
  static constexpr uint32_t bars = kQ + 2 * kStages * kKV;
  static constexpr uint32_t bytes = bars + 3 * kStages * 8 + 1024;
};

// One tile of the online softmax on a warpgroup's m64nN score fragment,
// in the log2 domain: scale (or soft-cap), mask (kMasked), the new row
// max m across the 4 threads of a row, corr = exp2(m_old - m), the
// probabilities in place, and this thread's part of the row sums l.
template <bool kMasked, bool kCapped, int kKeys>
__device__ __forceinline__ void softmax_tile(
    Frag<kKeys>& s, float (&m)[2], float (&l)[2], float (&corr)[2],
    const Mask& mask, const bool (&row_ok)[2], const int (&qpos)[2],
    int kcol, float scale, float cap) {
  const float sl2 = scale * kLog2e;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = s.x[4 * j + e];
      x = kCapped ? cap * tanhf(x * scale / cap) * kLog2e : x * sl2;
      if (kMasked &&
          !(row_ok[r] && mask.sees(qpos[r], kcol + 8 * j + (e & 1))))
        x = kNegInf;
      s.x[4 * j + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s.x[4 * j + e];
      const float pr =
          kMasked && x == kNegInf ? 0.f : exp2_approx(x - mx[e >> 1]);
      s.x[4 * j + e] = pr;
      l[e >> 1] += pr;         // this thread's part; summed at the end
    }
}

template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, Params p) {
  using Tl = Tile<D>;
  using L = Smem<D>;
  constexpr int W = Tl::W;
  constexpr int kKeys = L::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  // the query tile is the slowest grid dimension: heaviest tiles first
  const int iq = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int G = p.G, SG = p.S * G;
  const int r0 = iq * kRows;

  // keys any row of this block can see (as the fp32 kernel)
  const int q_lo = r0 / G, q_hi = (min(r0 + kRows, SG) - 1) / G;
  const int k_end = p.causal ? min(p.T, q_hi + 1) : p.T;
  const int k_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int n_tiles = max(0, (k_end - k_begin + kKeys - 1) / kKeys);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 2 * kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----------------------
    reg_dealloc<24>();
    if (tid == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = k_begin + i * kKeys;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_k[s], L::kKV);
        for (int c = 0; c < Tl::NH; ++c)
          tma_load_4d(sm + L::k(s) + c * kKeys * W, &kmap, &full_k[s],
                      c * (W / 2), h, k0, b);
        mbar_expect_tx(&full_v[s], L::kKV);
        for (int c = 0; c < Tl::NH; ++c)
          tma_load_4d(sm + L::v(s) + c * kKeys * W, &vmap, &full_v[s],
                      c * (W / 2), h, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns rows r0 + 64w .. r0 + 64w + 63 -------
  reg_alloc<240>();
  const int w = wg - 1, t = tid % kWarpgroup;
  const int warp = t / 32, lane = t % 32;
  const int wr0 = r0 + 64 * w;
  const Mask mask{SG, p.T, G, p.causal, p.window};

  load_rows_async<D, kRows>(sm + L::q, static_cast<const __nv_bfloat16*>(p.q),
                            r0, SG, G, h, b, p.q_sb, p.q_ss, p.q_sh,
                            t + w * kWarpgroup, 2 * kWarpgroup);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  named_bar_sync(1, 2 * kWarpgroup);     // both warpgroups load Q

  // this thread's two rows
  const int rowa = wr0 + 16 * warp + lane / 4, rowb = rowa + 8;
  const int col0 = 2 * (lane % 4);
  // mask only tiles that can hold a masked pair of this warpgroup's rows
  const int wq_lo = wr0 / G;
  const int wq_hi = (min(wr0 + 64, SG) - 1) / G;
  const bool ragged = wr0 + 64 > SG;
  const bool capped = p.cap > 0.f;
  const bool row_ok[2] = {rowa < SG, rowb < SG};
  const int qpos[2] = {rowa / G, rowb / G};

  const uint32_t q_addr = smem_u32(sm + L::q) + 64 * w * W;
  Frag<kKeys> s;
  Frag<D> o;
  o.zero();
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pa[kKeys / 4];

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t par = (i / kStages) & 1;
    const int k0 = k_begin + i * kKeys;
    const uint32_t k_addr = smem_u32(sm + L::k(st));
    const uint32_t v_addr = smem_u32(sm + L::v(st));

    // ---- S = Q K^T ----------------------------------------------------
    mbar_wait(&full_k[st], par);
    s.fence();
    wg_fence();
#pragma unroll
    for (int c = 0; c < Tl::NH; ++c)
#pragma unroll
      for (int kk = 0; kk < Tl::kKSteps; ++kk)
        wgmma_ss<0, 0>(
            s, make_desc(q_addr + c * kRows * W + kk * 32, 16, 8 * W,
                         Tl::kLayout),
            make_desc(k_addr + c * kKeys * W + kk * 32, 16, 8 * W,
                      Tl::kLayout),
            c | kk);
    wg_commit();
    wg_wait<0>();
    s.fence();

    // ---- online softmax on the fragment (log2 domain) -----------------
    const bool masked = ragged || k0 + kKeys > p.T ||
                        (p.causal && k0 + kKeys - 1 > wq_lo) ||
                        (p.window > 0 && wq_hi - k0 >= p.window);
    float corr[2];
    if (capped) {
      if (masked)
        softmax_tile<true, true>(s, m, l, corr, mask, row_ok, qpos, k0 + col0,
                                 p.scale, p.cap);
      else
        softmax_tile<false, true>(s, m, l, corr, mask, row_ok, qpos,
                                  k0 + col0, p.scale, p.cap);
    } else {
      if (masked)
        softmax_tile<true, false>(s, m, l, corr, mask, row_ok, qpos,
                                  k0 + col0, p.scale, p.cap);
      else
        softmax_tile<false, false>(s, m, l, corr, mask, row_ok, qpos,
                                   k0 + col0, p.scale, p.cap);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o.x[4 * j + e] *= corr[e >> 1];
    to_a_operand(s, pa);

    // ---- O += P V -----------------------------------------------------
    mbar_wait(&full_v[st], par);
    o.fence();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<1>(o, &pa[4 * kk],
                  make_desc(v_addr + kk * 16 * W, kKeys * W, 8 * W,
                            Tl::kLayout),
                  1);
    wg_commit();
    wg_wait<0>();
    o.fence();
    fence_regs(pa);
    mbar_arrive(&empty[st]);
  }

  // ---- epilogue: o = acc / max(l, 1e-30) in bf16, lse ------------------
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
  const long long o_sh = D, o_ss = (long long)p.Hkv * G * D,
                  o_sb = (long long)p.S * o_ss;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r ? rowb : rowa;
    if (row >= SG) continue;
    const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
    __nv_bfloat16* dst = out + row_offset(row, G, h, o_sb, o_ss, o_sh, b);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + col0) =
          pack_bf16(o.x[4 * j + 2 * r] * inv, o.x[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      p.lse[(long long)bh * SG + row] =
          (m[r] == kNegInf ? kNegInf : m[r] * kLn2) + logf(lc);
  }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  constexpr int kKeys = Smem<D>::kKeys;
  int e = tensor_map<D>(&kmap, p.k, B, p.T, p.Hkv, p.k_sb, p.k_st, p.k_sh,
                        1, kKeys);
  if (e) return e;
  e = tensor_map<D>(&vmap, p.v, B, p.T, p.Hkv, p.v_sb, p.v_st, p.v_sh, 1,
                    kKeys);
  if (e) return e;
  const int smem = int(Smem<D>::bytes);
  cudaError_t ce = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return int(ce);
  const int nq = (p.S * p.G + kRows - 1) / kRows;
  flash_fwd_sm90<D><<<dim3(B * p.Hkv, nq), kBlock, smem, stream>>>(
      kmap, vmap, p);
  return int(cudaGetLastError());
}

}  // namespace hop

template <int D>
int launch_one(const Params& p, int B, bool bf16, cudaStream_t s) {
  return bf16 ? hop::launch<D>(p, B, s) : launch_scalar<D>(p, B, s);
}

int launch_dim(const Params& p, int B, int D, bool bf16, cudaStream_t s) {
  switch (D) {
    case 16: return launch_one<16>(p, B, bf16, s);
    case 32: return launch_one<32>(p, B, bf16, s);
    case 64: return launch_one<64>(p, B, bf16, s);
    case 128: return launch_one<128>(p, B, bf16, s);
    case 256: return launch_one<256>(p, B, bf16, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (the wgmma kernel).
// q: (B, S, Hq, D), k/v: (B, T, Hkv, D), last dim contiguous, other
// strides in elements; for bfloat16 every pointer and byte stride is a
// multiple of 16 (TMA and 16-byte copies; the wrapper checks).  o:
// (B, S, Hq, D) contiguous; lse: fp32 (B, Hkv, S * G).  D in {16, 32,
// 64, 128, 256}.  Returns the cudaError_t of the launch (0 = success).
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
  if (dtype == 0 || dtype == 1) return launch_dim(p, B, D, dtype == 1, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
