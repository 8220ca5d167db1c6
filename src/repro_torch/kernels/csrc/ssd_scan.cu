// Mamba-2 SSD chunked scan for Hopper (sm_90a): one block per (head,
// batch row) walks the sequence chunk by chunk, carrying the (P, N)
// state in shared memory.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (launched by `ssd_scan_folded`, reached
// through `repro.kernels.ops.ssd_scan`).  Same function, in fp32: the
// sequence is cut into chunks of Q = min(chunk, S) rows; in a chunk,
// with dA = dt * A (A = -exp(A_log)) and csum its inclusive cumsum,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(csum_i - csum_j) dt_j x_j
//         + exp(csum_i) C_i . state                       (intra + inter)
//   state = state exp(csum_last)
//         + sum_j x_j (B_j exp(csum_last - csum_j) dt_j)^T (carried)
// with the mask applied before exp (above the diagonal the segment sums
// are positive and would overflow).  The state starts from zero or, when
// given, from an initial state (the serving prefill continues a slot's
// carried state; the reference's `ssd_chunked(init_state=)`).  The last
// chunk may be short: its missing rows are not computed, which equals
// the reference's dt = 0 padding (unit decay, zero contribution).
//
// What bounds it: at the serving shape (one prefill chunk of 32 tokens,
// 8 rows x 32 heads) the bytes: the (P, N) = 64 x 128 fp32 state is read
// and written once per (row, head), 16.8 MB of the call's ~19 MB, against
// ~0.19 GFLOP; cache-free (S 1024, chunk 256) the operations, about
// 1.2e8 flops per (row, head) in fp32 against 1 MB moved.
//
// What the design does about it:
//   * x (B, S, H, P), dt (B, S, H) and B/C (B, S, G, N) are read in the
//     model's layout through strides, head h reading group h / (H/G):
//     no folded copy, no repeat of the groups, no padding copy;
//   * the state stays in shared memory for the whole sequence and is
//     read and written once;
//   * a 256-row chunk's B and C (128 KB each in fp32) and its 256 x 256
//     scores do not fit the 227 KB of a block, so the chunk is cut into
//     SUB-row query and key sub-tiles (SUB = 16, 32 or 64, the least
//     that covers Q up to 64): the cumsum still spans the whole chunk;
//   * every product is a 16 x 16 thread grid of register tiles over
//     shared memory (fp32 FMAs; row strides padded to odd lengths so the
//     column reads are conflict-free).
// Tensor cores, a ring of TMA tile loads and splitting a long sequence
// across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

extern "C" {

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (x and y share x_dtype; B
// and C share bc_dtype, which is x_dtype or float32).  x, y: (B, S, H, P); dt: float32 (B, S, H);
// A_log: float32 (H,); B/C: (B, S, G, N); last dims contiguous, other
// strides in elements.  init_state (may be null) and final_state: float32
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
  if (x_dtype == 1 && bc_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, B, s);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch<__nv_bfloat16, float>(p, B, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
