// Decode attention for Hopper (sm_90a): one query token per (batch row,
// KV head) against that row's KV cache, split across a cluster of blocks.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// src/repro/kernels/decode_attention.py (launched by
// `decode_attention_folded`, reached through `repro.kernels.ops
// .decode_attention`).  Same function: the G = Hq/Hkv query heads of one
// KV head are the rows of a (G, D) query block; a key at index kpos
// counts when kpos < length, kpos < T and, with a window,
// length - kpos <= window; optional soft-cap cap*tanh(s/cap); q*scale in
// fp32; softmax with max, sum and accumulator in fp32; output
// acc / max(l, 1e-30) in q's dtype.  A row with length <= 0 reads no key
// and writes exactly 0.
//
// Beyond the TPU kernel: an optional per-key position array (B, T).  A
// local-attention layer's cache is a ring indexed by position mod T,
// so once it wraps a key's index is not its position, and a ragged
// prefill leaves position -1 on entries it wrote past its real tokens.
// With positions, the key at index t counts when its stored position
// pos satisfies 0 <= pos < length (the query sits at length - 1) and,
// with a window, length - pos <= window: the mask of the model's plain
// attention paths, exact on a wrapped ring.  All T entries are then
// visited, and a tile is loaded whole and masked on the scores.
//
// What bounds it: the bytes of K and V.  Each cached key and value is
// read once and used for G (4 on Qwen3-8B, 10 on RecurrentGemma-2B) dot
// products, so a call does about 2 flops per byte read, far under the
// card's ~295 flops/byte ridge, and its least time is (bytes of K/V that
// the lengths cover) over the memory rate.  At the serving shapes a call
// moves 0.5-8 MB, which 132 SMs read in 1-3 us, so what decides the time
// is latency: how many blocks are in flight and how many tile loads each
// keeps outstanding.
//
// What the design does about it:
//   * split-K: the grid is (splits, Hkv, B).  The host chooses `splits`
//     (<= 8, at most one block an SM: 2 at Qwen3-8B's serving shape, 8 at
//     RecurrentGemma-2B's) from T, B * Hkv, the SM count and the window,
//     never from the lengths (they stay on the device, so a decode step
//     can be captured in a CUDA graph).  Block s of a (b, h) pair takes
//     the s-th of
//     `splits` equal parts of the row's live range [kbeg, kend), which it
//     computes from the length itself;
//   * the splits of one (b, h) pair form a thread-block cluster.  Each
//     block leaves its per-row max m, sum l and G x D fp32 partial
//     accumulator in its shared memory; after cluster.sync() every block
//     combines a slice of the G x D outputs from all splits through
//     distributed shared memory, in split order (so the result does not
//     change from run to run), weighting split r by exp(m_r - m) where it
//     saw a counted key and by 0 where it did not.  One launch per call;
//     no scratch in device memory;
//   * a ring of 3 stages of K/V tiles, two in flight while one is used
//     (bf16: 2 stages when no split has more than 2 tiles, so all of them
//     are in flight at once and the block is smaller):
//     bf16 tiles of 64 keys by TMA (the 4-D tensor maps of flash_sm90.cuh
//     over k's and v's own strides, swizzled, completing on one mbarrier a
//     stage), fp32 tiles of 32 keys by 16-byte cp.async into XOR-swizzled
//     rows.  Keys outside the split's part of the live range are never in
//     a tile that is loaded, except at a tile's ragged end;
//   * K and V are read in the model's (B, T, Hkv, D) layout through
//     strides, so no folded copy of the cache is ever made;
//   * bf16 products on the tensor cores (mma.sync m16n8k16, the G <= 16
//     query rows padded to 16): warp w takes keys 16w .. 16w + 15 of each
//     tile with its own online softmax, so a tile costs one barrier; the
//     four warps' partials merge in shared memory before the cluster
//     combine (on the CUDA cores the products took most of the call);
//   * fp32 stays exact on the CUDA cores: D split across 4 neighbouring
//     lanes a key (two shuffles), the softmax one warp per query row, P V
//     one output column (two at D 256) a thread.
#include <cooperative_groups.h>

#include "flash_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using flash::from_f32;
using flash::kNegInf;
using flash::to_f32;
using namespace flash::sm90;

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;      // the ring's depth (bf16: at most)
constexpr int kMaxG = 16;       // query rows per KV head (one m16 tile)
constexpr int kMaxSplits = 8;   // a portable cluster
constexpr int kRowsPerWarp = kMaxG / kWarps;

// keys a tile: bf16 64 (16 a warp, the k16 of the P V product); fp32 32
// (one a lane in the softmax)
template <typename T>
__host__ __device__ constexpr int tile_keys() {
  return sizeof(T) == 2 ? 64 : 32;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  int T, G, splits, stages;
  long long q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  float scale;
  int window;
  float cap;
  const int* kpos;   // (B, T) stored key positions, or null: index
  long long kpos_sb;
};

// Byte offsets into the dynamic shared memory (from a 1024-byte aligned
// base): the K/V ring (after the loop: the warps' and the block's partial
// accumulators), the tiles' stored positions, q (bf16: 16 rows of D + 8
// for ldmatrix; fp32: G rows times scale), the fp32 path's probabilities,
// rescales and key mask, row max / sum of this split, the combine's
// weights and sums, barriers.
struct Layout {
  uint32_t ring, kpos, q, p, c, ok, ml, w, lsum, bars, bytes;
};

template <typename T, int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return uint32_t(tile_keys<T>()) * D * sizeof(T);
}

template <typename T, int D>
__host__ __device__ inline Layout layout(int G, int stages) {
  constexpr int K = tile_keys<T>();
  Layout L{};
  L.ring = 0;
  L.kpos = L.ring + 2 * stages * tile_bytes<T, D>();
  L.q = L.kpos + stages * K * 4;
  L.p = L.q + (sizeof(T) == 2 ? kMaxG * (D + 8) * 2 : uint32_t(G) * D * 4);
  L.c = L.p + kMaxG * K * 4;
  L.ok = L.c + kMaxG * 4;
  L.ml = L.ok + K * 4;
  L.w = L.ml + 2 * kMaxG * 4;
  L.lsum = L.w + kMaxSplits * kMaxG * 4;
  L.bars = L.lsum + kMaxG * 4;
  L.bytes = L.bars + stages * 8 + 1024;    // + the base's alignment
  return L;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 4 bytes global -> shared; 0 where !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// four 8x8 b16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); .trans hands out their transposes
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 K or V tile: 32 rows of D floats whose 16-byte chunks are
// XOR-swizzled by the row, so the 8 rows a warp reads at once fall in
// different banks.  (bf16 tiles are Tile<D>'s swizzled panels, as TMA
// writes them.)
template <int D>
struct F32Tile {
  static constexpr int R = tile_keys<float>();
  static constexpr int NC = D / 4;             // 16-byte chunks a row
  static constexpr int SW = NC < 8 ? NC - 1 : 7;

  __device__ __forceinline__ static uint32_t chunk_offset(int r, int c) {
    return uint32_t(r * D * 4 + ((c ^ (r & SW)) << 4));
  }
  __device__ __forceinline__ static float4 chunk(const uint8_t* tile, int r,
                                                 int c) {
    return *reinterpret_cast<const float4*>(tile + chunk_offset(r, c));
  }
  __device__ __forceinline__ static float elem(const uint8_t* tile, int r,
                                               int d) {
    return *reinterpret_cast<const float*>(tile + chunk_offset(r, d / 4) +
                                           (d % 4) * 4);
  }
};

// Start the loads of tile i (keys sb + i * R ..) into stage i % S:
// K and V (bf16: TMA by thread 0 on the stage's mbarrier; fp32: cp.async
// by every thread, keys past se read 0) and the stored positions
// (cp.async).  The caller commits the cp.async group.
template <typename T, int D>
__device__ __forceinline__ void load_tile(
    uint8_t* sm, const Layout& L, const CUtensorMap* kmap,
    const CUtensorMap* vmap, uint64_t* full, const T* k, const T* v,
    const int* kpos, long long k_st, long long v_st, int sb, int se, int h,
    int b, int i, int S) {
  constexpr int R = tile_keys<T>();
  constexpr uint32_t KV = tile_bytes<T, D>();
  const int tid = threadIdx.x;
  const int st = i % S;
  const int t0 = sb + i * R;
  uint8_t* kt = sm + L.ring + 2 * st * KV;
  uint8_t* vt = kt + KV;
  if constexpr (sizeof(T) == 2) {
    if (tid == 0) {
      constexpr int W = Tile<D>::W;
      mbar_expect_tx(&full[st], 2 * KV);
      for (int c = 0; c < Tile<D>::NH; ++c) {
        tma_load_4d(kt + c * R * W, kmap, &full[st], c * (W / 2), h, t0, b);
        tma_load_4d(vt + c * R * W, vmap, &full[st], c * (W / 2), h, t0, b);
      }
    }
  } else {
    using Ft = F32Tile<D>;
    for (int x = tid; x < R * Ft::NC; x += kThreads) {
      const int r = x / Ft::NC, c = x - r * Ft::NC;
      const int t = t0 + r;
      const bool ok = t < se;
      const uint32_t off = Ft::chunk_offset(r, c);
      cp_async16(kt + off, ok ? k + t * k_st + 4 * c : k, ok);
      cp_async16(vt + off, ok ? v + t * v_st + 4 * c : v, ok);
    }
  }
  if (kpos && tid < R) {
    int* kpos_s = reinterpret_cast<int*>(sm + L.kpos);
    const int t = t0 + tid;
    cp_async4(kpos_s + st * R + tid, t < se ? kpos + t : kpos, t < se);
  }
}

// Does the key at index t (t < se: in this split's part) count for a
// query whose row has `length` keys?
__device__ __forceinline__ bool key_counts(int t, int se, const int* kpos_s,
                                           int j, bool by_pos, int length,
                                           int window) {
  if (t >= se) return false;
  const int pos = by_pos ? kpos_s[j] : t;
  return pos >= 0 && pos < length && (window <= 0 || length - pos <= window);
}

// bf16, one tile on the tensor cores: warp w takes keys 16w .. 16w + 15
// of the tile for all 16 (padded) query rows.  S = Q K^T and O += P V are
// m16n8k16 products (Q and K by ldmatrix, V by ldmatrix.trans from the
// swizzled tiles); the warp keeps its own online softmax (rows lane / 4
// and lane / 4 + 8, the row max across the lane's quad), P goes from the
// S fragments straight to the A operand of P V.
template <int D>
__device__ __forceinline__ void tile_mma(
    uint32_t q_addr, uint32_t k_addr, uint32_t v_addr, const int* kpos_s,
    int t0, int se, bool by_pos, int length, const Params& p,
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2]) {
  using Tl = Tile<D>;
  constexpr int R = tile_keys<__nv_bfloat16>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = 16 * warp;
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  // ldmatrix rows of this lane: Q (row, chunk), K (key, chunk), V (key, chunk)
  const int qr = (lane & 7) + 8 * ((lane >> 3) & 1), qc = lane >> 4;
  const int kr = kw + (lane & 7) + 8 * (lane >> 4), kc = (lane >> 3) & 1;
  const int vr = kw + (lane & 7) + 8 * ((lane >> 3) & 1), vc = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4], bk[4];
    ldsm_x4(q_addr + qr * (D + 8) * 2 + (2 * ks + qc) * 16, a);
    ldsm_x4(k_addr + Tl::offset(R, kr, (2 * ks + kc) * 8), bk);
    mma_bf16(s[0], a, bk[0], bk[1]);
    mma_bf16(s[1], a, bk[2], bk[3]);
  }
  // scale, cap, mask; the row max over the quad
  bool ok[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = kw + 8 * nt + 2 * (lane & 3) + e;
      ok[nt][e] = key_counts(t0 + j, se, kpos_s, j, by_pos, length, p.window);
    }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * p.scale;
      if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
      x = ok[nt][e & 1] ? x : kNegInf;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = expf(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
  uint32_t pa[4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = ok[nt][0] ? expf(s[nt][2 * r] - mx[r]) : 0.f;
      const float p1 = ok[nt][1] ? expf(s[nt][2 * r + 1] - mx[r]) : 0.f;
      l[r] += p0 + p1;                   // this lane's part; summed later
      pa[2 * nt + r] = pack_bf16(p0, p1);
    }
  // O = O * corr + P V
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    o[nt][0] *= corr[0];
    o[nt][1] *= corr[0];
    o[nt][2] *= corr[1];
    o[nt][3] *= corr[1];
  }
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t bv[4];
    ldsm_x4_t(v_addr + Tl::offset(R, vr, (2 * j + vc) * 8), bv);
    mma_bf16(o[2 * j], pa, bv[0], bv[1]);
    mma_bf16(o[2 * j + 1], pa, bv[2], bv[3]);
  }
}

// fp32, one tile on the CUDA cores (exact fp32): scores with D split
// across kParts lanes a key, the softmax one warp per query row, P V one
// output column (two at D 256) a thread for all G rows.
template <int D>
__device__ __forceinline__ void tile_fma(
    const uint8_t* kt, const uint8_t* vt, const float* q_s, float* p_s,
    float* c_s, int* ok_s, const int* kpos_s, int t0, int se, bool by_pos,
    int length, const Params& p, float (&acc)[kMaxG][(D + kThreads - 1) / kThreads],
    float (&m_run)[kRowsPerWarp], float (&l_run)[kRowsPerWarp]) {
  using Ft = F32Tile<D>;
  constexpr int R = Ft::R, NC = Ft::NC;
  constexpr int kParts = kThreads / R;
  constexpr int DC = (D + kThreads - 1) / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G;
  {
    const int j = tid / kParts, part = tid % kParts;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = part; c < NC; c += kParts) {
      const float4 kx = Ft::chunk(kt, j, c);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float4 x = *reinterpret_cast<const float4*>(q_s + g * D + 4 * c);
          s[g] = fmaf(x.x, kx.x, s[g]);
          s[g] = fmaf(x.y, kx.y, s[g]);
          s[g] = fmaf(x.z, kx.z, s[g]);
          s[g] = fmaf(x.w, kx.w, s[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
    }
    if (part == 0) {
      const bool ok = key_counts(t0 + j, se, kpos_s, j, by_pos, length,
                                 p.window);
      ok_s[j] = ok;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float x = s[g];
          if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
          p_s[g * R + j] = ok ? x : kNegInf;
        }
      }
    }
  }
  __syncthreads();
  {
    const bool valid = ok_s[lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = warp + r * kWarps;
      if (g < G) {
        const float s = p_s[g * R + lane];
        const float m_new = fmaxf(m_run[r], warp_max(s));
        const float pj = valid ? expf(s - m_new) : 0.f;
        const float corr = expf(m_run[r] - m_new);
        l_run[r] = l_run[r] * corr + warp_sum(pj);
        m_run[r] = m_new;
        p_s[g * R + lane] = pj;
        if (lane == 0) c_s[g] = corr;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = tid + c * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g][c] *= c_s[g];
#pragma unroll 4
      for (int j = 0; j < R; ++j) {
        const float vv = Ft::elem(vt, j, d);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][c] = fmaf(p_s[g * R + j], vv, acc[g][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int R = tile_keys<T>();
  constexpr uint32_t KV = tile_bytes<T, D>();
  constexpr int DC = (D + kThreads - 1) / kThreads;   // fp32: columns a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int G = p.G;
  const int S = kBf16 ? p.stages : kStages;   // the ring's depth
  const Layout L = layout<T, D>(G, S);
  int* kpos_s = reinterpret_cast<int*>(sm + L.kpos);
  float* ml_s = reinterpret_cast<float*>(sm + L.ml);
  float* w_s = reinterpret_cast<float*>(sm + L.w);
  float* lsum_s = reinterpret_cast<float*>(sm + L.lsum);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * G * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.out) + b * p.o_sb + (long long)h * G * p.o_sh;

  if (kBf16 && tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&vmap)) : "memory");
  }
  // the row's live range: by index only [length - window, length) can
  // count; with positions (a ring) any index can; length <= 0: none
  const int length = p.lengths[b];
  const int* kpos = p.kpos ? p.kpos + b * p.kpos_sb : nullptr;
  int kbeg = 0, kend = 0;
  if (length > 0) {
    kend = kpos ? p.T : min(length, p.T);
    if (!kpos && p.window > 0) kbeg = max(0, length - p.window);
  }
  // this split's part of it
  const int per = (max(0, kend - kbeg) + p.splits - 1) / p.splits;
  const int sb = min(kend, kbeg + split * per);
  const int se = min(kend, sb + per);
  const int n_tiles = (se - sb + R - 1) / R;

  if (kBf16 && tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  for (int i = 0; i < S - 1; ++i) {
    if (i < n_tiles)
      load_tile<T, D>(sm, L, &kmap, &vmap, full, k, v, kpos, p.k_st, p.v_st,
                       sb, se, h, b, i, S);
    cp_async_commit();
  }

  // q: bf16 as it is, 16 rows (zero past G) of D + 8 for ldmatrix, the
  // scale applied to the fp32 scores; fp32 times scale
  if constexpr (kBf16) {
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(sm + L.q);
    for (int i = tid; i < kMaxG * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      q_s[g * (D + 8) + d] = g < G ? q[g * p.q_sh + d] : __float2bfloat16(0.f);
    }
  } else {
    float* q_s = reinterpret_cast<float*>(sm + L.q);
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      q_s[i] = to_f32(q[g * p.q_sh + d]) * p.scale;
    }
  }

  // bf16: this warp's O fragment and row state (rows lane / 4, + 8)
  float ob[kBf16 ? D / 8 : 1][4];
  float mb[2] = {kNegInf, kNegInf}, lb[2] = {0.f, 0.f};
  // fp32: this thread's output columns, the warp's rows' state
  float acc[kMaxG][DC];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
  if constexpr (kBf16) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ob[nt][e] = 0.f;
  } else {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m_run[r] = kNegInf;
      l_run[r] = 0.f;
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % S;
    // this thread's copies of tile i (S - 2 later groups may be pending)
    if (S == kStages)
      cp_async_wait<kStages - 2>();
    else
      cp_async_wait<0>();
    if (kBf16) mbar_wait(&full[st], (i / S) & 1);
    // everyone's copies of tile i are in, and tile i - 1 is used up, so
    // its stage takes tile i + S - 1
    __syncthreads();
    if (i + S - 1 < n_tiles)
      load_tile<T, D>(sm, L, &kmap, &vmap, full, k, v, kpos, p.k_st, p.v_st,
                       sb, se, h, b, i + S - 1, S);
    cp_async_commit();
    const uint8_t* kt = sm + L.ring + 2 * st * KV;
    const int t0 = sb + i * R;
    if constexpr (kBf16)
      tile_mma<D>(smem_u32(sm + L.q), smem_u32(kt), smem_u32(kt + KV),
                  kpos_s + st * R, t0, se, kpos != nullptr, length, p, ob, mb,
                  lb);
    else
      tile_fma<D>(kt, kt + KV, reinterpret_cast<const float*>(sm + L.q),
                  reinterpret_cast<float*>(sm + L.p),
                  reinterpret_cast<float*>(sm + L.c),
                  reinterpret_cast<int*>(sm + L.ok), kpos_s + st * R, t0, se,
                  kpos != nullptr, length, p, acc, m_run, l_run);
  }

  // ---- this split's partials: m, l and acc [G][D] into shared memory ----
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free
  float* part = reinterpret_cast<float*>(sm + L.ring);   // [G][D]
  if constexpr (kBf16) {
    // the four warps' partials [warp][16][D] and (m, l), merged in order
    float* wpart = part + G * D;
    float* wml = reinterpret_cast<float*>(sm + L.p);     // [2][warp][16]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 1);
      lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 2);
      const int row = lane / 4 + 8 * r;
      if (row < G) {
        if ((lane & 3) == 0) {
          wml[warp * kMaxG + row] = mb[r];
          wml[(kWarps + warp) * kMaxG + row] = lb[r];
        }
        float* dst = wpart + (warp * kMaxG + row) * D + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<float2*>(dst + 8 * nt) =
              make_float2(ob[nt][2 * r], ob[nt][2 * r + 1]);
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      float mw = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, wml[w * kMaxG + g]);
      float x = 0.f, lw = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float l_w = wml[(kWarps + w) * kMaxG + g];
        const float c = l_w > 0.f ? expf(wml[w * kMaxG + g] - mw) : 0.f;
        x = fmaf(c, wpart[w * kMaxG * D + i], x);
        lw = fmaf(c, l_w, lw);
      }
      part[i] = x;
      if (i - g * D == 0) {
        ml_s[g] = mw;
        ml_s[kMaxG + g] = lw;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = warp + r * kWarps;
      if (g < G && lane == 0) {
        ml_s[g] = m_run[r];
        ml_s[kMaxG + g] = l_run[r];
      }
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tid + c * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g * D + d] = acc[g][c];
      }
    }
  }
  cluster.sync();

  // ---- combine across the cluster, splits in order ---------------------
  const int n = p.splits;
  if (tid < G) {
    const int g = tid;
    float mr[kMaxSplits], lr[kMaxSplits], m = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n) {
        const float* ml = cluster.map_shared_rank(ml_s, r);
        mr[r] = ml[g];
        lr[r] = ml[kMaxG + g];
        m = fmaxf(m, mr[r]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n) {
        // a split that saw no counted key has l = 0 and weighs nothing
        const float w = lr[r] > 0.f ? expf(mr[r] - m) : 0.f;
        w_s[r * kMaxG + g] = w;
        l += w * lr[r];
      }
    }
    lsum_s[g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = split * kThreads + tid; i < G * D; i += n * kThreads) {
    const int g = i / D, d = i - g * D;
    float x = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n) {
        const float w = w_s[r * kMaxG + g];
        if (w != 0.f) x = fmaf(w, cluster.map_shared_rank(part, r)[i], x);
      }
    }
    o[g * p.o_sh + d] = from_f32<T>(x / lsum_s[g]);
  }
  cluster.sync();                          // peers are done reading ours
}

template <typename T, int D>
int launch(Params p, int B, int Hkv, cudaStream_t stream) {
  // bf16: the ring holds 3 tiles, or 2 when no split has more (all of a
  // split's tiles are then in flight from the start, and the smaller
  // block leaves room for more blocks an SM); fp32: 3
  constexpr int R = tile_keys<T>();
  const int live = p.kpos || p.window <= 0 || p.window > p.T ? p.T : p.window;
  const int tiles = ((live + p.splits - 1) / p.splits + R - 1) / R;
  p.stages = sizeof(T) == 2 && tiles < kStages ? 2 : kStages;
  CUtensorMap kmap = {}, vmap = {};
  if (sizeof(T) == 2) {
    int e = tensor_map<D>(&kmap, p.k, B, p.T, Hkv, p.k_sb, p.k_st, p.k_sh, 1,
                          R);
    if (e) return e;
    e = tensor_map<D>(&vmap, p.v, B, p.T, Hkv, p.v_sb, p.v_st, p.v_sh, 1, R);
    if (e) return e;
  }
  const int smem = int(layout<T, D>(p.G, p.stages).bytes);
  static int smem_set = 0;                 // per instantiation
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, D>,
                                     kmap, vmap, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int B, int Hkv, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, Hkv, s);
    case 32: return launch<T, 32>(p, B, Hkv, s);
    case 64: return launch<T, 64>(p, B, Hkv, s);
    case 128: return launch<T, 128>(p, B, Hkv, s);
    case 256: return launch<T, 256>(p, B, Hkv, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/out: (B, 1, Hq, D), k/v: (B, T,
// Hkv, D), last dim contiguous, other strides in elements, every base
// address and byte stride of k/v a multiple of 16.  lengths: int32 (B,).
// kpos: int32 (B, T) with row stride kpos_sb and a contiguous last dim,
// or null (a key's position is its index).  D in {16, 32, 64, 128, 256};
// G <= 16; 1 <= splits <= 8 blocks (a cluster) a (b, h) pair.  Returns
// the cudaError_t of the launch (0 = success).
int decode_attention(int dtype, const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int T, int Hkv,
                     int G, int D, int splits, long long q_sb, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     long long o_sb, long long o_sh, float scale, int window,
                     float cap, const int* kpos, long long kpos_sb,
                     void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || G < 1 || G > kMaxG || splits < 1 ||
      splits > kMaxSplits)
    return int(cudaErrorInvalidValue);
  Params p{q, k, v, lengths, out, T, G, splits, kStages, q_sb, q_sh, k_sb,
           k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh, scale, window, cap, kpos,
           kpos_sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, B, Hkv, D, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, B, Hkv, D, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
