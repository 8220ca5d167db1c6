// One WLBVT dispatch round for Hopper (sm_90a) over [R, T] replica x
// tenant lanes.
//
// Replaces the Pallas TPU kernel `_select_kernel` of
// src/repro/kernels/wlbvt_select.py (launched by `_rounds_pallas`,
// switched by `wlbvt_select_rounds`).  Same function: the metric
// (total_occup / max(bvt, 1)) / prio is hoisted out of the pick loop; each
// pick k recomputes pu_limit = ceil(P * prio / max(psum, 1e-9) - 1e-6)
// over the non-empty queues (P when none is non-empty), makes a lane
// eligible when ql > 0 and co < lim, takes the first argmin of the
// eligible metrics (BIG = 1e30 elsewhere), and grants it when some lane
// is eligible and k < free_k: ql -= 1, co += 1.  picks[r, k] is the lane
// or -1.  float and double; the plain version is
// kernels/ref.py::wlbvt_select_rounds_ref, and the two agree bit for bit:
//   * every product and quotient is written with the _rn intrinsics, so
//     no multiply is contracted into an FMA, and the build uses IEEE
//     division (no --use_fast_math);
//   * the sum of non-empty priorities is taken in one fixed order, the
//     order of core/sched_generic.py::lane_sum: a halving tree inside each
//     warp of 32 lanes (zero padded), then the warps left to right;
//   * the argmin is a shuffle min over (metric, lane) pairs in which the
//     lower lane wins a tie, as argmin's first index does (at t = 0 every
//     metric is 0, so ties are the common case).
//
// What bounds it: neither bytes nor operations but latency.  A call reads
// five [R, T] arrays and free_k and writes picks, ql and co once (about
// 1 MB at the sweep shape R 256, T 8 in double), and each pick is a
// chain of dependent shuffles and, for T > 32, block barriers.  The
// design keeps the whole round in registers: one thread per tenant lane,
// one warp per replica row when T <= 32 (four rows to a block of 128
// threads), one block of ceil(T/32) warps per row when T <= 128; each
// lane's inputs are loaded once, and a row stops once it can grant no
// more.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxT = 128;
constexpr int kMaxPicks = 128;
constexpr int kBlockThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float ceil_(float a) { return ceilf(a); }
__device__ __forceinline__ double ceil_(double a) { return ceil(a); }

// (m, i) := the lower of (m, i) and (m2, i2): smaller metric, then lower lane
template <typename F>
__device__ __forceinline__ void take_min(F& m, int& i, F m2, int i2) {
  if (m2 < m || (m2 == m && i2 < i)) {
    m = m2;
    i = i2;
  }
}

template <typename F>
__global__ void __launch_bounds__(kBlockThreads)
wlbvt_select_kernel(const F* __restrict__ prio, const int* __restrict__ ql_in,
                    const int* __restrict__ co_in, const F* __restrict__ to,
                    const F* __restrict__ bvt, const int* __restrict__ free_k,
                    int* __restrict__ picks, int* __restrict__ ql_out,
                    int* __restrict__ co_out, int R, int T, int num_pus,
                    int max_picks, int warps_per_row, int rows_per_block) {
  // per (row of the block, warp of the row): partial sum, argmin, any
  __shared__ F s_sum[kBlockThreads / kWarp];
  __shared__ F s_min[kBlockThreads / kWarp];
  __shared__ int s_idx[kBlockThreads / kWarp];
  __shared__ int s_any[kBlockThreads / kWarp];

  const int row_threads = warps_per_row * kWarp;
  const int rb = threadIdx.x / row_threads;         // row within the block
  const int t = threadIdx.x % row_threads;          // tenant lane
  const int warp = t / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * rows_per_block + rb;
  const bool row_ok = r < R;
  const bool valid = row_ok && t < T;
  const size_t off = size_t(r) * T + t;
  const int slot = rb * warps_per_row;              // first s_* entry of the row

  F p = F(1);
  int q = 0, c = 0;
  F metric = F(0);
  if (valid) {
    p = prio[off];
    q = ql_in[off];
    c = co_in[off];
    const F b = bvt[off];
    metric = div_rn(div_rn(to[off], b > F(1) ? b : F(1)), p);
  }
  const int fk = row_ok ? free_k[r] : 0;
  const F big = F(1e30), eps = F(1e-6), tiny = F(1e-9);
  const F pus = F(num_pus);

  // `live`: the row granted at every pick so far.  A row that grants
  // nothing at pick k never grants again (its state did not change), so
  // the block stops once no row of it can grant, and the picks left are -1.
  bool live = row_ok;
  int k = 0;
  for (; k < max_picks; ++k) {
    // every thread of the block reaches each barrier of the loop body
    if (!__syncthreads_or(live && k < fk)) break;
    // psum over the non-empty queues: tree in the warp, warps in order
    F v = (valid && q > 0) ? p : F(0);
#pragma unroll
    for (int o = kWarp / 2; o >= 1; o >>= 1)
      v = add_rn(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) s_sum[slot + warp] = v;
    __syncthreads();
    F psum = s_sum[slot];
    for (int w = 1; w < warps_per_row; ++w) psum = add_rn(psum, s_sum[slot + w]);
    const F lim = psum > F(0)
        ? ceil_(sub_rn(div_rn(mul_rn(pus, p), psum > tiny ? psum : tiny), eps))
        : pus;
    const bool elig = valid && q > 0 && F(c) < lim;
    // first argmin over (masked metric, lane); pad lanes never win
    F m = valid ? (elig ? metric : big) : F(INFINITY);
    int idx = valid ? t : kMaxT;
#pragma unroll
    for (int o = kWarp / 2; o >= 1; o >>= 1) {
      const F m2 = __shfl_xor_sync(kFull, m, o);
      const int i2 = __shfl_xor_sync(kFull, idx, o);
      take_min(m, idx, m2, i2);
    }
    const int any_w = __any_sync(kFull, elig);
    if (lane == 0) {
      s_min[slot + warp] = m;
      s_idx[slot + warp] = idx;
      s_any[slot + warp] = any_w;
    }
    __syncthreads();
    m = s_min[slot];
    idx = s_idx[slot];
    int any = s_any[slot];
    for (int w = 1; w < warps_per_row; ++w) {
      take_min(m, idx, s_min[slot + w], s_idx[slot + w]);
      any |= s_any[slot + w];
    }
    const bool can = live && any && k < fk;
    if (can && t == idx) {
      q -= 1;
      c += 1;
    }
    if (row_ok && t == 0) picks[size_t(r) * max_picks + k] = can ? idx : -1;
    live = can;
  }
  if (row_ok) {
    for (int kk = k + t; kk < max_picks; kk += row_threads)
      picks[size_t(r) * max_picks + kk] = -1;
    if (valid) {
      ql_out[off] = q;
      co_out[off] = c;
    }
  }
}

template <typename F>
int launch(const void* prio, const int* ql, const int* co, const void* to,
           const void* bvt, const int* free_k, int* picks, int* ql_out,
           int* co_out, int R, int T, int num_pus, int max_picks,
           cudaStream_t stream) {
  const int warps_per_row = (T + kWarp - 1) / kWarp;
  const int rows_per_block = (kBlockThreads / kWarp) / warps_per_row;
  const int threads = rows_per_block * warps_per_row * kWarp;
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  wlbvt_select_kernel<F><<<blocks, threads, 0, stream>>>(
      static_cast<const F*>(prio), ql, co, static_cast<const F*>(to),
      static_cast<const F*>(bvt), free_k, picks, ql_out, co_out, R, T,
      num_pus, max_picks, warps_per_row, rows_per_block);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64 (prio, to, bvt).  prio/to/bvt/ql/co:
// contiguous [R, T]; free_k: [R]; picks: [R, max_picks]; ql_out/co_out:
// [R, T], apart from ql/co.  All int arrays int32.  Returns the
// cudaError_t of the launch (0 = success).
int wlbvt_select(int dtype, const void* prio, const int* ql, const int* co,
                 const void* to, const void* bvt, const int* free_k,
                 int* picks, int* ql_out, int* co_out, int R, int T,
                 int num_pus, int max_picks, void* stream) {
  if (T < 1 || T > kMaxT || max_picks < 0 || max_picks > kMaxPicks || R < 0)
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(prio, ql, co, to, bvt, free_k, picks, ql_out, co_out,
                         R, T, num_pus, max_picks, s);
  if (dtype == 1)
    return launch<double>(prio, ql, co, to, bvt, free_k, picks, ql_out,
                          co_out, R, T, num_pus, max_picks, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
