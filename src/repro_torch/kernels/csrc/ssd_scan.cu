// Mamba-2 SSD chunked scan for Hopper (sm_90a): one block per (head,
// batch row) walks the sequence chunk by chunk, carrying the (P, N)
// state in shared memory.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (launched by `ssd_scan_folded`, reached
// through `repro.kernels.ops.ssd_scan`).  Same function, in fp32: the
// sequence is cut into chunks of Q rows; in a chunk, with dA = dt * A
// (A = -exp(A_log)) and csum its inclusive cumsum,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(csum_i - csum_j) dt_j x_j
//         + exp(csum_i) C_i . state                       (intra + inter)
//   state = state exp(csum_last)
//         + sum_j x_j (B_j exp(csum_last - csum_j) dt_j)^T (carried)
// with the mask applied before exp (above the diagonal the segment sums
// are positive and would overflow).  The chunked form is the same
// function for any chunk length.  The state starts from zero or, when
// given, from an initial state (the serving prefill continues a slot's
// carried state; the reference's `ssd_chunked(init_state=)`).  The last
// chunk may be short: its missing rows are not computed, which equals
// the reference's dt = 0 padding (unit decay, zero contribution).
//
// What bounds it: at the serving shape (one prefill chunk of 32 tokens,
// 8 rows x 32 heads) the bytes: the (P, N) = 64 x 128 fp32 state is read
// and written once per (row, head), 16.8 MB of the call's 19.0 MB (5.7 us
// at the memory rate), against 0.32 GFLOP (the chunk's scores and
// products, the inter-chunk term and the state update); cache-free (S
// 1024, chunk 256, B 4) the bytes too, just: 40.4 MB (12.1 us) against
// 10.2 GFLOP (10.3 us at the tensor cores' bf16 rate; the hi + lo pairs
// below double three of the four products).
//
// Two kernels.  x, B and C in bf16, as the model serves them, run on the
// tensor cores (`ssd_scan_tc`); fp32 x (and bf16 x with fp32 B/C) run the
// exact scalar kernel (`ssd_scan_kernel`).
//
// `ssd_scan_tc`, what its design does about the bound:
//   * copies are 16-byte cp.async, each thread's completing on an
//     mbarrier: warps 0-3 copy the chunk's x, B and C while warp 4 loads dt
//     and takes the cumsum; once they have landed, warps 4-7 issue the 64 x
//     128 fp32 initial state (32 KB) into padded rows, and it lands while
//     the block computes C B^T, the mask, the decays, P and the weights W.
//     (Issued together with the inputs, the state's bytes delayed them;
//     one cp.async.bulk a row was tried first, but the compiler issues the
//     lanes' bulk copies one after another, 64 of them on one warp before
//     any work.)  After the last chunk the state
//     update runs before y: it goes from its fragments straight to
//     final_state (16 bytes a lane after a swap with the neighbour lane)
//     and leaves the state in shared memory as it was, so its stores
//     stream out while y's inter-chunk term still reads the old state.
//     Before the last chunk the update follows y.  y leaves in 16-byte
//     stores;
//   * the four products of a chunk, C B^T (Q x Q over N), P x (Q x P over
//     Q; P = the masked, decayed scores times dt_j), C state^T (Q x P over
//     N) and x^T W (P x N over Q; W_j = B_j dt_j exp(csum_last - csum_j)),
//     run as mma.sync m16n8k16 in bf16 with fp32 sums (Q = 32 is under
//     wgmma's 64-row tile), their operands read by ldmatrix from rows
//     padded by 16 bytes (conflict-free).  x, B and C go in as they are;
//     the fp32 operands, P, W and the carried state, go in as a bf16 hi +
//     lo pair, two products that keep ~16 bits (TF32 would keep 11).  The
//     state stays fp32 in shared memory and is never stored rounded.
//     `ref.ssd_scan_bf16_ref` is this order and rounding in plain torch;
//   * a serving call is one chunk a block, so each instruction runs about
//     once a launch and is fetched cold: the phases' times follow their
//     code size more than their arithmetic (`chip_smoke.py` phase 15
//     prints them, from a build with -DSSD_PHASE_TRACE).  So the loops
//     stay rolled, each epilogue is one small loop (the masked scores go
//     through shared memory as fp32 and are decayed elementwise), the
//     cumsum runs in log2 units so that each exp is one exp2, and a
//     state that starts from zero is written by the first update, not
//     zero-filled;
//   * chunks of at most 64 rows: a longer chunk runs as 64-row chunks (the
//     quadratic terms shrink; the linear ones stay).  At Q <= 32 a block
//     takes 88 KB of shared memory, so two fit an SM and the serving
//     shape's 256 blocks run in one wave; at 64 rows 157 KB;
//   * inputs whose rows are not 16-byte aligned (P or N not a multiple of
//     8, odd strides or addresses) are loaded and stored element by
//     element by the same kernel.
//
// `ssd_scan_kernel`, the scalar kernel:
//   * x (B, S, H, P), dt (B, S, H) and B/C (B, S, G, N) are read in the
//     model's layout through strides, head h reading group h / (H/G):
//     no folded copy, no repeat of the groups, no padding copy (both
//     kernels);
//   * the state stays in shared memory for the whole sequence and is
//     read and written once (both kernels);
//   * a 256-row chunk's B and C (128 KB each in fp32) and its 256 x 256
//     scores do not fit the 227 KB of a block, so the chunk is cut into
//     SUB-row query and key sub-tiles (SUB = 16, 32 or 64, the least
//     that covers Q up to 64): the cumsum still spans the whole chunk;
//   * every product is a 16 x 16 thread grid of register tiles over
//     shared memory (fp32 FMAs; row strides padded to odd lengths so the
//     column reads are conflict-free).
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using flash::from_f32;
using flash::to_f32;
using namespace flash::sm90;


constexpr int kThreads = 256;   // a 16 x 16 grid over 64 x 64 output tiles
constexpr int kMaxQ = 256;      // chunk rows: one thread each for the cumsum
constexpr int kMaxP = 64;       // head dim
constexpr int kMaxN = 128;      // state dim
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* x;
  const float* dt;
  const float* A_log;
  const void* Bm;
  const void* Cm;
  const float* init_state;   // (B, H, P, N) contiguous, or null (zero)
  void* y;
  float* final_state;        // (B, H, P, N) contiguous
  int S, H, G, P, N, Q;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
      c_sb, c_ss, c_sg, y_sb, y_ss, y_sh;
};

__host__ __device__ inline int padded_n(int N) { return (N + 63) / 64 * 64; }

size_t smem_floats(int sub, int N) {
  const int ld = padded_n(N) + 1;
  // state [64][ld], C and B tiles [sub][ld], x tile [sub][64],
  // scores [sub][sub+1], dt and cumsum [kMaxQ], warp totals
  return size_t(kMaxP) * ld + 2 * size_t(sub) * ld + size_t(sub) * kMaxP +
         size_t(sub) * (sub + 1) + 2 * kMaxQ + kWarps;
}

// acc[r][c] += sum_k A[i][k] * Bt[j][k], i = ty + 16 r, j = tx + 16 c
template <int R, int C>
__device__ __forceinline__ void mm_abt(float (&acc)[R][C], const float* A,
                                       int lda, const float* Bt, int ldb,
                                       int K, int tx, int ty) {
  for (int k = 0; k < K; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = A[(ty + 16 * r) * lda + k];
#pragma unroll
    for (int c = 0; c < C; ++c) bv[c] = Bt[(tx + 16 * c) * ldb + k];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc[r][c] += sum_k A[i][k] * Bn[k][j], i = ty + 16 r, j = tx + 16 c
template <int R, int C>
__device__ __forceinline__ void mm_ab(float (&acc)[R][C], const float* A,
                                      int lda, const float* Bn, int ldb,
                                      int K, int tx, int ty) {
  for (int k = 0; k < K; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = A[(ty + 16 * r) * lda + k];
#pragma unroll
    for (int c = 0; c < C; ++c) bv[c] = Bn[k * ldb + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc[r][c] += sum_k At[k][i] * Bn[k][j], i = ty + 16 r, j = tx + 16 c
template <int R, int C>
__device__ __forceinline__ void mm_atb(float (&acc)[R][C], const float* At,
                                       int lda, const float* Bn, int ldb,
                                       int K, int tx, int ty) {
  for (int k = 0; k < K; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = At[k * lda + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < C; ++c) bv[c] = Bn[k * ldb + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// rows [row0, row0 + rows) of a (S, N) operand -> fp32 tile [SUB][ld];
// rows past `rows` and columns past N are zero
template <typename TB, int SUB>
__device__ __forceinline__ void load_bc(float* dst, const TB* src,
                                        long long stride, int row0, int rows,
                                        int N, int ld, int tx, int ty) {
  const int np = ld - 1;
  for (int r = ty; r < SUB; r += 16) {
    const TB* row = src + (long long)(row0 + r) * stride;
    for (int n = tx; n < np; n += 16)
      dst[r * ld + n] = (r < rows && n < N) ? to_f32(row[n]) : 0.f;
  }
}

// rows [row0, row0 + rows) of x, each times w[r] -> fp32 tile [SUB][64]
template <typename TX, int SUB>
__device__ __forceinline__ void load_x(float* dst, const TX* src,
                                       long long stride, int row0, int rows,
                                       int P, const float* w, int tx,
                                       int ty) {
  for (int r = ty; r < SUB; r += 16) {
    const TX* row = src + (long long)(row0 + r) * stride;
    const float wr = r < rows ? w[r] : 0.f;
    for (int p = tx; p < kMaxP; p += 16)
      dst[r * kMaxP + p] = (r < rows && p < P) ? to_f32(row[p]) * wr : 0.f;
  }
}

template <typename TX, typename TB, int SUB>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  constexpr int R = SUB / 16;     // register-tile rows per thread
  extern __shared__ float smem[];
  const int N = p.N, P = p.P, ld = padded_n(N) + 1, nb = padded_n(N) / 64;
  float* st_s = smem;                    // [64][ld] carried state
  float* c_s = st_s + kMaxP * ld;        // [SUB][ld] C query sub-tile
  float* b_s = c_s + SUB * ld;           // [SUB][ld] B key sub-tile
  float* x_s = b_s + SUB * ld;           // [SUB][64] weighted x sub-tile
  float* s_s = x_s + SUB * kMaxP;        // [SUB][SUB+1] masked scores
  float* dt_s = s_s + SUB * (SUB + 1);   // [kMaxQ] dt of the chunk
  float* cs_s = dt_s + kMaxQ;            // [kMaxQ] inclusive cumsum of dA
  float* wt_s = cs_s + kMaxQ;            // [kWarps] warp totals

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y, g = h / (p.H / p.G);
  const float A = -expf(p.A_log[h]);
  const TX* x = static_cast<const TX*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const TB* Bm = static_cast<const TB*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const TB* Cm = static_cast<const TB*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  TX* y = static_cast<TX*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long st_off = ((long long)b * p.H + h) * P * N;

  for (int pp = ty; pp < kMaxP; pp += 16)
    for (int n = tx; n < ld - 1; n += 16)
      st_s[pp * ld + n] = (p.init_state && pp < P && n < N)
                              ? p.init_state[st_off + pp * N + n] : 0.f;
  bool state_zero = p.init_state == nullptr;

  for (int s0 = 0; s0 < p.S; s0 += p.Q) {
    const int Qc = min(p.Q, p.S - s0);
    // ---- dt and the inclusive cumsum of dA over the chunk -------------
    float v = 0.f;
    if (tid < Qc) {
      const float d = dt[(long long)(s0 + tid) * p.dt_ss];
      dt_s[tid] = d;
      v = d * A;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wt_s[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wt_s[w];
    if (tid < Qc) cs_s[tid] = v;
    __syncthreads();
    const float cs_last = cs_s[Qc - 1];
    const int nsub = (Qc + SUB - 1) / SUB;

    // ---- y of each query sub-tile: inter-chunk + intra-chunk terms ----
    for (int qi = 0; qi < nsub; ++qi) {
      const int i0 = qi * SUB, ri = min(SUB, Qc - i0);
      load_bc<TB, SUB>(c_s, Cm, p.c_ss, s0 + i0, ri, N, ld, tx, ty);
      __syncthreads();
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (!state_zero) {   // (C_i . state) exp(csum_i)
        mm_abt<R, 4>(acc, c_s, ld, st_s, ld, N, tx, ty);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = ty + 16 * r;
          const float e = i < ri ? expf(cs_s[i0 + i]) : 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] *= e;
        }
      }
      for (int kj = 0; kj <= qi; ++kj) {
        const int j0 = kj * SUB, rj = min(SUB, Qc - j0);
        load_bc<TB, SUB>(b_s, Bm, p.b_ss, s0 + j0, rj, N, ld, tx, ty);
        load_x<TX, SUB>(x_s, x, p.x_ss, s0 + j0, rj, P, dt_s + j0, tx, ty);
        __syncthreads();
        float sc[R][R];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c) sc[r][c] = 0.f;
        mm_abt<R, R>(sc, c_s, ld, b_s, ld, N, tx, ty);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = ty + 16 * r;
#pragma unroll
          for (int c = 0; c < R; ++c) {
            const int j = tx + 16 * c;
            // the mask before exp: only j <= i is ever exponentiated
            const bool keep = i < ri && j < rj && j0 + j <= i0 + i;
            s_s[i * (SUB + 1) + j] =
                keep ? sc[r][c] * expf(cs_s[i0 + i] - cs_s[j0 + j]) : 0.f;
          }
        }
        __syncthreads();
        mm_ab<R, 4>(acc, s_s, SUB + 1, x_s, kMaxP, rj, tx, ty);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ty + 16 * r;
        if (i >= ri) continue;
        TX* row = y + (long long)(s0 + i0 + i) * p.y_ss;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx + 16 * c;
          if (pp < P) row[pp] = from_f32<TX>(acc[r][c]);
        }
      }
    }

    // ---- state = state exp(csum_last) + sum_j x_j^T (B_j w_j) ----------
    // w_j = dt_j exp(csum_last - csum_j), folded into the x tile
    if (tid < Qc) dt_s[tid] *= expf(cs_last - cs_s[tid]);
    float acc2[2][4][4];
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc2[cb][r][c] = 0.f;
    for (int kj = 0; kj < nsub; ++kj) {
      const int j0 = kj * SUB, rj = min(SUB, Qc - j0);
      __syncthreads();
      load_bc<TB, SUB>(b_s, Bm, p.b_ss, s0 + j0, rj, N, ld, tx, ty);
      load_x<TX, SUB>(x_s, x, p.x_ss, s0 + j0, rj, P, dt_s + j0, tx, ty);
      __syncthreads();
#pragma unroll
      for (int cb = 0; cb < 2; ++cb)
        if (cb < nb)
          mm_atb<4, 4>(acc2[cb], x_s, kMaxP, b_s + cb * 64, ld, rj, tx, ty);
    }
    const float total = expf(cs_last);
    __syncthreads();
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = ty + 16 * r, n = cb * 64 + tx + 16 * c;
          if (cb < nb && pp < P && n < N)
            st_s[pp * ld + n] = st_s[pp * ld + n] * total + acc2[cb][r][c];
        }
    state_zero = false;
    __syncthreads();
  }

  for (int pp = ty; pp < P; pp += 16)
    for (int n = tx; n < N; n += 16)
      p.final_state[st_off + pp * N + n] = st_s[pp * ld + n];
}

template <typename TX, typename TB, int SUB>
int launch_sub(const Params& p, int B, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once, to what the largest
  // state needs, so a launch (or a CUDA-graph capture) makes no other call
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<TX, TB, SUB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_floats(SUB, kMaxN) * sizeof(float)));
    if (e != cudaSuccess) return int(e);
    limit_set = true;
  }
  const size_t smem = smem_floats(SUB, p.N) * sizeof(float);
  ssd_scan_kernel<TX, TB, SUB><<<dim3(p.H, B), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename TX, typename TB>
int launch(const Params& p, int B, cudaStream_t stream) {
  if (p.Q <= 16) return launch_sub<TX, TB, 16>(p, B, stream);
  if (p.Q <= 32) return launch_sub<TX, TB, 32>(p, B, stream);
  return launch_sub<TX, TB, 64>(p, B, stream);
}


// ---------------------------------------------------------------------------
// ssd_scan_tc: x, B and C in bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

#ifdef SSD_PHASE_TRACE
// clock64 at the phase boundaries of every block's first chunk, read back
// by `chip_smoke.py`'s `ssd_phases` (which builds this source with
// -DSSD_PHASE_TRACE; the library the port loads has none)
constexpr int kPhases = 7;
__device__ long long g_phase[1024][kPhases];
#define PHASE(k)                                                          \
  do {                                                                    \
    const int blk_ = blockIdx.y * gridDim.x + blockIdx.x;                 \
    if (threadIdx.x == 0 && blk_ < 1024) g_phase[blk_][k] = clock64();    \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;

// Shared memory: offsets in bytes, every one a multiple of 16.
struct Layout {
  int Np, Pp;                  // N and P rounded up to the MMA's 16
  int ldn, ldp, ldq;           // row strides in elements, 16 bytes (bf16)
                               // or 32 (fp32) over: the fragments' reads
                               // are conflict-free
  unsigned st, sc, c, b, whi, wlo, x, y, phi, plo, dt, cs, w, e, bar, bytes;
};

__host__ __device__ inline Layout layout(int KC, int N, int P) {
  Layout L;
  L.Np = (N + 15) / 16 * 16;
  L.Pp = (P + 15) / 16 * 16;
  L.ldn = L.Np + 8;
  L.ldp = L.Pp + 8;
  L.ldq = KC + 8;
  unsigned o = 0;
  L.st = o;  o += L.Pp * L.ldn * 4;      // fp32 state [Pp][ldn]
  L.sc = o;  o += KC * L.ldq * 4;        // fp32 C B^T [KC][ldq]
  L.c = o;   o += KC * L.ldn * 2;        // bf16 C, B, W hi, W lo [KC][ldn]
  L.b = o;   o += KC * L.ldn * 2;
  L.whi = o; o += KC * L.ldn * 2;
  L.wlo = o; o += KC * L.ldn * 2;
  L.x = o;   o += KC * L.ldp * 2;        // bf16 x, y [KC][ldp]
  L.y = o;   o += KC * L.ldp * 2;
  L.phi = o; o += KC * L.ldq * 2;        // bf16 P hi, P lo [KC][ldq]
  L.plo = o; o += KC * L.ldq * 2;
  L.dt = o;  o += KC * 4;                // fp32 dt, csum, w, exp(csum)
  L.cs = o;  o += KC * 4;
  L.w = o;   o += KC * 4;
  L.e = o;   o += KC * 4;
  L.bar = o; o += 16;                    // mbarriers: inputs, state
  L.bytes = o;
  return L;
}

// ldmatrix lane addresses (bytes; bf16 rows of `ld` elements from `base`)
// A operand (16 x 16 at m0, k0) of an [m][k] tile
__device__ __forceinline__ uint32_t a_mk(uint32_t base, int ld, int m0,
                                         int k0, int lane) {
  return base + 2u * ((m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
                      (lane >> 4) * 8);
}
// A operand (16 x 16 at m0, k0) of a [k][m] tile, read with .trans
__device__ __forceinline__ uint32_t a_km(uint32_t base, int ld, int k0,
                                         int m0, int lane) {
  return base + 2u * ((k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
                      ((lane >> 3) & 1) * 8);
}
// B operands of two n8 tiles (16 x 16 at n0, k0) of an [n][k] tile
__device__ __forceinline__ uint32_t b_nk(uint32_t base, int ld, int n0,
                                         int k0, int lane) {
  return base + 2u * ((n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                      ((lane >> 3) & 1) * 8);
}
// B operands of two n8 tiles (16 x 16 at k0, n0) of a [k][n] tile, read
// with .trans
__device__ __forceinline__ uint32_t b_kn(uint32_t base, int ld, int k0,
                                         int n0, int lane) {
  return base + 2u * ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                      (lane >> 4) * 8);
}

// (u, v) -> bf16 pairs hi and lo with hi + lo = (u, v) to ~16 bits
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(u - hf.x, v - hf.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(l);
}

__device__ __forceinline__ void st_u32(bf16* dst, uint32_t v) {
  *reinterpret_cast<uint32_t*>(dst) = v;
}

// a 16 x 16 accumulator (two n8 tiles) -> rows r0.., columns c0.. of a
// row-major fp32 or bf16 tile
__device__ __forceinline__ void store_frag(float* dst, int ld, int r0, int c0,
                                           int gq, int tq,
                                           const float (&acc)[2][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // (n8 tile, row half)
    const int nt = q >> 1, hf = q & 1;
    *reinterpret_cast<float2*>(dst + (r0 + gq + 8 * hf) * ld + c0 + 8 * nt +
                               2 * tq) =
        make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  }
}
__device__ __forceinline__ void store_frag(bf16* dst, int ld, int r0, int c0,
                                           int gq, int tq,
                                           const float (&acc)[2][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int nt = q >> 1, hf = q & 1;
    const __nv_bfloat162 v =
        __floats2bfloat162_rn(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    st_u32(dst + (r0 + gq + 8 * hf) * ld + c0 + 8 * nt + 2 * tq,
           reinterpret_cast<const uint32_t&>(v));
  }
}

// A 16 x 16 tile of the final state (rows r0.., columns c0..) from its
// fragments: with `vec`, lanes tq and tq ^ 1 swap halves so that each
// stores 16 bytes (the even lane row gq, the odd lane row gq + 8);
// padding rows and columns are not stored.
__device__ __forceinline__ void store_state(float* dst, int P, int N, int r0,
                                            int c0, int gq, int tq, bool vec,
                                            const float2 (&v)[2][2]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    if (vec) {
      const bool odd = tq & 1;
      const float2 send = odd ? v[nt][0] : v[nt][1];
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                     __shfl_xor_sync(0xffffffffu, send.y, 1));
      const int r = r0 + gq + (odd ? 8 : 0), c = c0 + 8 * nt + 4 * (tq >> 1);
      if (r < P && c < N)
        *reinterpret_cast<float4*>(dst + (long long)r * N + c) =
            odd ? make_float4(got.x, got.y, v[nt][1].x, v[nt][1].y)
                : make_float4(v[nt][0].x, v[nt][0].y, got.x, got.y);
    } else {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + gq + 8 * hf, c = c0 + 8 * nt + 2 * tq;
        if (r < P && c < N) dst[(long long)r * N + c] = v[nt][hf].x;
        if (r < P && c + 1 < N) dst[(long long)r * N + c + 1] = v[nt][hf].y;
      }
    }
  }
}

// (row, column) of element t, t + nt, t + 2 nt, ... of a tile `cols` wide,
// stepped without a division
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Walk(int t, int nt, int cols_) : cols(cols_) {
    r = t / cols;
    c = t - r * cols;
    dr = nt / cols;
    dc = nt - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// rows [0, rows) of a bf16 operand (row stride `stride`) -> [rows_pad][ld]
// in shared memory, zero past `rows` and past `cols` up to `cols_pad`;
// threads t of nt.  `vec` (cols % 8 == 0, 16-byte aligned rows): 16-byte
// cp.async copies, which the caller waits for; else element by element.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long stride, int rows,
                                          int rows_pad, int cols,
                                          int cols_pad, bool vec, int t,
                                          int nt) {
  if (vec) {
#pragma unroll 1
    for (Walk w(t, nt, cols_pad / 8); w.r < rows_pad; w.next()) {
      const int c = 8 * w.c;
      const bool in = w.r < rows && c < cols;
      cp_async16(dst + w.r * ld + c, in ? src + w.r * stride + c : src, in);
    }
  } else {
#pragma unroll 1
    for (Walk w(t, nt, cols_pad); w.r < rows_pad; w.next())
      dst[w.r * ld + w.c] = w.r < rows && w.c < cols
                                ? src[w.r * stride + w.c]
                                : __float2bfloat16(0.f);
  }
}

template <int KC>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_scan_tc(Params p, int vec) {
  PHASE(0);
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const Layout L = layout(KC, p.N, p.P);
  float* st_s = reinterpret_cast<float*>(smem_tc + L.st);
  float* sc_s = reinterpret_cast<float*>(smem_tc + L.sc);
  bf16* c_s = reinterpret_cast<bf16*>(smem_tc + L.c);
  bf16* b_s = reinterpret_cast<bf16*>(smem_tc + L.b);
  bf16* whi_s = reinterpret_cast<bf16*>(smem_tc + L.whi);
  bf16* wlo_s = reinterpret_cast<bf16*>(smem_tc + L.wlo);
  bf16* x_s = reinterpret_cast<bf16*>(smem_tc + L.x);
  bf16* y_s = reinterpret_cast<bf16*>(smem_tc + L.y);
  bf16* phi_s = reinterpret_cast<bf16*>(smem_tc + L.phi);
  bf16* plo_s = reinterpret_cast<bf16*>(smem_tc + L.plo);
  float* dt_s = reinterpret_cast<float*>(smem_tc + L.dt);
  float* cs_s = reinterpret_cast<float*>(smem_tc + L.cs);
  float* w_s = reinterpret_cast<float*>(smem_tc + L.w);
  float* e_s = reinterpret_cast<float*>(smem_tc + L.e);
  uint64_t* in_bar = reinterpret_cast<uint64_t*>(smem_tc + L.bar);
  uint64_t* st_bar = in_bar + 1;
  const uint32_t base = smem_u32(smem_tc);
  const uint32_t c_a = base + L.c, b_a = base + L.b, whi_a = base + L.whi,
                 wlo_a = base + L.wlo, x_a = base + L.x,
                 phi_a = base + L.phi, plo_a = base + L.plo;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // a fragment's row, column pair
  const int h = blockIdx.x, b = blockIdx.y, g = h / (p.H / p.G);
  const int N = p.N, P = p.P, Np = L.Np, Pp = L.Pp;
  const int ldn = L.ldn, ldp = L.ldp, ldq = L.ldq;
  const bf16* x = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const bf16* Bm = static_cast<const bf16*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const bf16* Cm = static_cast<const bf16*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  bf16* y = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long st_off = ((long long)b * p.H + h) * P * N;
  const float* st_in = p.init_state ? p.init_state + st_off : nullptr;
  float* st_out = p.final_state + st_off;

  // Copies are 16-byte cp.async, each thread's completing on an mbarrier:
  // warps 0-3 copy a chunk's x, B and C (in_bar), warps 4-7 the initial
  // state (st_bar), all issued at once.  Unaligned inputs are loaded
  // element by element by every thread.
  constexpr int kHalf = kTcThreads / 2;
  const bool async = st_in && vec;
  if (tid == 0) {
    mbar_init(in_bar, kHalf);
    mbar_init(st_bar, kHalf);
    mbar_init_fence();
  }
  // the state's padding (columns N.. and rows P.. of the MMA tiles), or,
  // unaligned, all of it; from zero the first update writes the whole tile
  if (st_in)
#pragma unroll 1
    for (int r = warp; r < Pp; r += kTcWarps)
#pragma unroll 1
      for (int n = (async && r < P ? N : 0) + lane; n < Np; n += 32)
        st_s[r * ldn + n] = r < P && n < N ? st_in[(long long)r * N + n] : 0.f;
  __syncthreads();
  bool state_zero = st_in == nullptr, state_wait = async;
  uint32_t in_phase = 0;
  PHASE(1);

  // The code below runs once a chunk, and a serving call is one chunk:
  // every instruction is fetched cold, so the loops stay rolled (the
  // instruction fetch, not the arithmetic, set the time of an unrolled
  // version) and each epilogue is one small loop.
  const int Qk = min(p.Q, KC);
#pragma unroll 1
  for (int s0 = 0; s0 < p.S; s0 += Qk) {
    const int Qc = min(Qk, p.S - s0), Qp = (Qc + 15) & ~15, mt = Qp / 16;
    if (!vec || tid < kHalf) {
      const int nt = vec ? kHalf : kTcThreads;
      load_rows(c_s, ldn, Cm + s0 * p.c_ss, p.c_ss, Qc, Qp, N, Np, vec, tid,
                nt);
      load_rows(b_s, ldn, Bm + s0 * p.b_ss, p.b_ss, Qc, Qp, N, Np, vec, tid,
                nt);
      load_rows(x_s, ldp, x + s0 * p.x_ss, p.x_ss, Qc, Qp, P, Pp, vec, tid,
                nt);
      if (vec) cp_async_mbar_arrive(in_bar);
    }
    if (warp == kTcWarps / 2) {
      // dt and the inclusive cumsum of dA (a warp that copies no inputs):
      // lane l holds rows 2l and 2l + 1; in log2 units, so that every exp
      // is one exp2
      const float A = -expf(p.A_log[h]) * 1.44269504f;
      const int r0 = 2 * lane;
      const float d0 = r0 < Qc ? dt[(long long)(s0 + r0) * p.dt_ss] : 0.f;
      const float d1 =
          r0 + 1 < Qc ? dt[(long long)(s0 + r0 + 1) * p.dt_ss] : 0.f;
      const float a0 = d0 * A, a1 = d1 * A;
      float v = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      float ex = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0) ex = 0.f;
      const float c0 = ex + a0, c1 = c0 + a1;
      const int rl = Qc - 1;
      const float cl = __shfl_sync(0xffffffffu, rl & 1 ? c1 : c0, rl >> 1);
      if (r0 < KC) {
        dt_s[r0] = d0;
        cs_s[r0] = c0;
        w_s[r0] = d0 * exp2f(cl - c0);
        e_s[r0] = exp2f(c0);
      }
      if (r0 + 1 < KC) {
        dt_s[r0 + 1] = d1;
        cs_s[r0 + 1] = c1;
        w_s[r0 + 1] = d1 * exp2f(cl - c1);
        e_s[r0 + 1] = exp2f(c1);
      }
    }
    if (vec) {
      mbar_wait(in_bar, in_phase);
      in_phase ^= 1;
    }
    if (async && s0 == 0 && tid >= kHalf) {
      // the state's 32 KB after the inputs, so that they do not queue
      // behind it: it lands while the scores, P and W are computed
#pragma unroll 1
      for (Walk wk(tid - kHalf, kHalf, N / 4); wk.r < P; wk.next())
        cp_async16(st_s + wk.r * ldn + 4 * wk.c,
                   st_in + (long long)wk.r * N + 4 * wk.c, true);
      cp_async_mbar_arrive(st_bar);
    }
    __syncthreads();
    if (s0 == 0) PHASE(2);

    // ---- C B^T, 16 x 16 tiles on and below the diagonal -> sc_s --------
#pragma unroll 1
    for (int task = warp; task < mt * (mt + 1) / 2; task += kTcWarps) {
      int mi = 0;
      while ((mi + 1) * (mi + 2) / 2 <= task) ++mi;
      const int nb = task - mi * (mi + 1) / 2;            // nb <= mi
      float s[2][4] = {};
#pragma unroll 1
      for (int k0 = 0; k0 < Np; k0 += 16) {
        uint32_t a[4], bb[4];
        ldsm_x4(a_mk(c_a, ldn, 16 * mi, k0, lane), a);
        ldsm_x4(b_nk(b_a, ldn, 16 * nb, k0, lane), bb);
        mma_bf16(s[0], a, bb[0], bb[1]);
        mma_bf16(s[1], a, bb[2], bb[3]);
      }
      store_frag(sc_s, ldq, 16 * mi, 16 * nb, gq, tq, s);
    }
    // ---- W = B o w, w_j = dt_j exp(cs_last - cs_j), as hi and lo --------
#pragma unroll 1
    for (Walk wk(tid, kTcThreads, Np / 2); wk.r < Qp; wk.next()) {
      const int j = wk.r, n = 2 * wk.c;
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b_s + j * ldn + n));
      uint32_t hi, lo;
      split2(bv.x * w_s[j], bv.y * w_s[j], hi, lo);
      st_u32(whi_s + j * ldn + n, hi);
      st_u32(wlo_s + j * ldn + n, lo);
    }
    __syncthreads();
    if (s0 == 0) PHASE(3);

    // ---- P = (C B^T) o exp(cs_i - cs_j) o dt_j, j <= i, as hi and lo ----
#pragma unroll 1
    for (Walk wk(tid, kTcThreads, Qp / 2); wk.r < Qp; wk.next()) {
      const int i = wk.r, j = 2 * wk.c;
      const float2 sv = *reinterpret_cast<const float2*>(sc_s + i * ldq + j);
      // the mask before exp: only j <= i is exponentiated
      const float v0 = j <= i && i < Qc
                           ? sv.x * exp2f(cs_s[i] - cs_s[j]) * dt_s[j] : 0.f;
      const float v1 = j + 1 <= i && i < Qc
                           ? sv.y * exp2f(cs_s[i] - cs_s[j + 1]) * dt_s[j + 1]
                           : 0.f;
      uint32_t hi, lo;
      split2(v0, v1, hi, lo);
      st_u32(phi_s + i * ldq + j, hi);
      st_u32(plo_s + i * ldq + j, lo);
    }
    __syncthreads();
    if (s0 == 0) PHASE(4);

    // ---- y = exp(cs_i) (C . state) + P x, and the state update
    // state = state exp(cs_last) + x^T W.  After the last chunk the update
    // goes from its fragments to final_state and leaves the state in
    // shared memory as it was, so it runs first and its stores stream out
    // while y is computed; before, it runs after y, whose inter-chunk term
    // reads the state it replaces.
    const int pbn = Pp / 16;
    const bool last = s0 + Qk >= p.S;
    const float total = exp2f(cs_s[Qc - 1]);
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if ((pass == 0) == last) {
        if (state_wait) mbar_wait(st_bar, 0);
        state_wait = false;
#pragma unroll 1
        for (int task = warp; task < pbn * (Np / 16); task += kTcWarps) {
          const int pm = task % pbn, nb = task / pbn;
          float acc[2][4] = {};
#pragma unroll 1
          for (int k0 = 0; k0 < Qp; k0 += 16) {
            uint32_t a[4], bh[4], bl[4];
            ldsm_x4_t(a_km(x_a, ldp, k0, 16 * pm, lane), a);
            ldsm_x4_t(b_kn(whi_a, ldn, k0, 16 * nb, lane), bh);
            ldsm_x4_t(b_kn(wlo_a, ldn, k0, 16 * nb, lane), bl);
            mma_bf16(acc[0], a, bh[0], bh[1]);
            mma_bf16(acc[1], a, bh[2], bh[3]);
            mma_bf16(acc[0], a, bl[0], bl[1]);
            mma_bf16(acc[1], a, bl[2], bl[3]);
          }
          float2 v[2][2];   // (n8 tile, row half)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int nt = q >> 1, hf = q & 1;
            float2* sp = reinterpret_cast<float2*>(
                st_s + (16 * pm + gq + 8 * hf) * ldn + 16 * nb + 8 * nt +
                2 * tq);
            v[nt][hf] = make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
            if (!state_zero) {
              const float2 u = *sp;
              v[nt][hf].x += u.x * total;
              v[nt][hf].y += u.y * total;
            }
            if (!last) *sp = v[nt][hf];
          }
          if (last)
            store_state(st_out, P, N, 16 * pm, 16 * nb, gq, tq, vec, v);
        }
      } else {
#pragma unroll 1
        for (int task = warp; task < mt * pbn; task += kTcWarps) {
          const int mi = task % mt, pb = task / mt;
          float yi[2][4] = {}, ye[2][4] = {};
#pragma unroll 1
          for (int k0 = 0; k0 <= 16 * mi; k0 += 16) {
            uint32_t ah[4], al[4], bx[4];
            ldsm_x4(a_mk(phi_a, ldq, 16 * mi, k0, lane), ah);
            ldsm_x4(a_mk(plo_a, ldq, 16 * mi, k0, lane), al);
            ldsm_x4_t(b_kn(x_a, ldp, k0, 16 * pb, lane), bx);
            mma_bf16(yi[0], ah, bx[0], bx[1]);
            mma_bf16(yi[1], ah, bx[2], bx[3]);
            mma_bf16(yi[0], al, bx[0], bx[1]);
            mma_bf16(yi[1], al, bx[2], bx[3]);
          }
          if (!state_zero) {
            if (state_wait) mbar_wait(st_bar, 0);   // the first chunk's state
#pragma unroll 1
            for (int k0 = 0; k0 < Np; k0 += 16) {
              uint32_t a[4];
              ldsm_x4(a_mk(c_a, ldn, 16 * mi, k0, lane), a);
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const float* sr =
                    st_s + (16 * pb + 8 * nt + gq) * ldn + k0 + 2 * tq;
                const float2 u = *reinterpret_cast<const float2*>(sr);
                const float2 v = *reinterpret_cast<const float2*>(sr + 8);
                uint32_t h0, l0, h1, l1;
                split2(u.x, u.y, h0, l0);
                split2(v.x, v.y, h1, l1);
                mma_bf16(ye[nt], a, h0, h1);
                mma_bf16(ye[nt], a, l0, l1);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {   // (n8 tile, row half, column)
            const int nt = q >> 2, hf = (q >> 1) & 1, e = q & 1;
            yi[nt][2 * hf + e] +=
                e_s[16 * mi + gq + 8 * hf] * ye[nt][2 * hf + e];
          }
          store_frag(y_s, ldp, 16 * mi, 16 * pb, gq, tq, yi);
        }
        if (state_wait) mbar_wait(st_bar, 0);   // warps with no task
        state_wait = false;
        __syncthreads();
        if (vec) {
#pragma unroll 1
          for (Walk wk(tid, kTcThreads, P / 8); wk.r < Qc; wk.next())
            *reinterpret_cast<uint4*>(y + (long long)(s0 + wk.r) * p.y_ss +
                                      8 * wk.c) = *reinterpret_cast<
                const uint4*>(y_s + wk.r * ldp + 8 * wk.c);
        } else {
#pragma unroll 1
          for (Walk wk(tid, kTcThreads, P); wk.r < Qc; wk.next())
            y[(long long)(s0 + wk.r) * p.y_ss + wk.c] =
                y_s[wk.r * ldp + wk.c];
        }
      }
      __syncthreads();
      if (s0 == 0) PHASE(5 + pass);
    }
    state_zero = false;
  }
}

template <int KC>
int launch(const Params& p, int B, bool vec, cudaStream_t stream) {
  // raise the shared-memory limit once, to what the largest shapes need,
  // so a launch (or a CUDA-graph capture) makes no other call
  static bool limit_set = false;
  if (!limit_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_tc<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(layout(KC, kMaxN, kMaxP).bytes));
    if (e != cudaSuccess) return int(e);
    limit_set = true;
  }
  ssd_scan_tc<KC><<<dim3(p.H, B), kTcThreads, layout(KC, p.N, p.P).bytes,
                    stream>>>(p, vec);
  return int(cudaGetLastError());
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// 16-byte loads and stores: every row of x, B, C, y and the states starts
// on a 16-byte boundary and holds whole 16-byte pieces
bool vectorizable(const Params& p) {
  bool ok = p.P % 8 == 0 && p.N % 8 == 0 && aligned16(p.x) &&
            aligned16(p.Bm) && aligned16(p.Cm) && aligned16(p.y) &&
            aligned16(p.final_state) &&
            (!p.init_state || aligned16(p.init_state));
  const long long strides[] = {p.x_sb, p.x_ss, p.x_sh, p.b_sb,
                               p.b_ss, p.b_sg, p.c_sb, p.c_ss,
                               p.c_sg, p.y_sb, p.y_ss, p.y_sh};
  for (long long s : strides) ok = ok && s % 8 == 0;
  return ok;
}

int launch_any(const Params& p, int B, cudaStream_t stream) {
  const bool vec = vectorizable(p);
  return p.Q <= 32 ? launch<32>(p, B, vec, stream)
                   : launch<64>(p, B, vec, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (x and y share x_dtype; B
// and C share bc_dtype, which is x_dtype or float32; both bf16 run the
// tensor-core kernel).  x, y: (B, S, H, P); dt: float32 (B, S, H); A_log:
// float32 (H,); B/C: (B, S, G, N); last dims contiguous, other strides in
// elements.  init_state (may be null) and final_state: float32
// (B, H, P, N) contiguous.  Q = min(chunk, S).  Returns the cudaError_t of
// the launch (0 = success).
int ssd_scan(int x_dtype, int bc_dtype, const void* x, const float* dt,
             const float* A_log, const void* Bm, const void* Cm,
             const float* init_state, void* y, float* final_state, int B,
             int S, int H, int G, int P, int N, int Q, long long x_sb,
             long long x_ss, long long x_sh, long long dt_sb,
             long long dt_ss, long long dt_sh, long long b_sb,
             long long b_ss, long long b_sg, long long c_sb, long long c_ss,
             long long c_sg, long long y_sb, long long y_ss, long long y_sh,
             void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || P > kMaxP ||
      N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ)
    return int(cudaErrorInvalidValue);
  Params p{x, dt, A_log, Bm, Cm, init_state, y, final_state, S, H, G, P, N,
           Q, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
           c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0) return launch<float, float>(p, B, s);
  if (x_dtype == 1 && bc_dtype == 1) return tc::launch_any(p, B, s);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch<__nv_bfloat16, float>(p, B, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef SSD_PHASE_TRACE
// the first `blocks` blocks' phase clocks, [blocks][7]
int ssd_phase_read(long long* dst, int blocks) {
  return int(cudaMemcpyFromSymbol(dst, tc::g_phase,
                                  size_t(blocks) * tc::kPhases * 8));
}
#endif

}  // extern "C"
