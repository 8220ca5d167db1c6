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
// kernels/ref.py::wlbvt_select_rounds_ref, and the two agree bit for bit.
// Each pick is wlbvt_round.cuh's `round_pick`, the round that
// sweep_scan.cu runs in each step of the sweep's scan: one definition, so
// the standalone round checked here is the round the scan runs.
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

#include "wlbvt_round.cuh"

namespace {

using wlbvt::kWarp;
constexpr int kMaxT = wlbvt::kMaxLanes;
constexpr int kMaxPicks = 128;
constexpr int kBlockThreads = 128;

struct BlockBarrier {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

template <typename F>
__global__ void __launch_bounds__(kBlockThreads)
wlbvt_select_kernel(const F* __restrict__ prio, const int* __restrict__ ql_in,
                    const int* __restrict__ co_in, const F* __restrict__ to,
                    const F* __restrict__ bvt, const int* __restrict__ free_k,
                    int* __restrict__ picks, int* __restrict__ ql_out,
                    int* __restrict__ co_out, int R, int T, int num_pus,
                    int max_picks, int warps_per_row, int rows_per_block) {
  // each row's cross-warp partials (rows of several warps)
  __shared__ wlbvt::RoundScratch<F> s_round[kBlockThreads / kWarp];

  const int row_threads = warps_per_row * kWarp;
  const int rb = threadIdx.x / row_threads;         // row within the block
  const int t = threadIdx.x % row_threads;          // tenant lane
  const int r = blockIdx.x * rows_per_block + rb;
  const bool row_ok = r < R;
  const bool valid = row_ok && t < T;
  const size_t off = size_t(r) * T + t;

  F p = F(1);
  int q = 0, c = 0;
  F metric = F(0);
  if (valid) {
    p = prio[off];
    q = ql_in[off];
    c = co_in[off];
    const F b = bvt[off];
    metric = wlbvt::div_rn(wlbvt::div_rn(to[off], b > F(1) ? b : F(1)), p);
  }
  const int fk = row_ok ? free_k[r] : 0;
  const F pus = F(num_pus);

  // `live`: the row granted at every pick so far.  A row that grants
  // nothing at pick k never grants again (its state did not change), so
  // the block stops once no row of it can grant, and the picks left are -1.
  bool live = row_ok;
  int k = 0;
  for (; k < max_picks; ++k) {
    // every thread of the block reaches each barrier of the loop body
    if (!__syncthreads_or(live && k < fk)) break;
    bool any;
    const int idx = wlbvt::round_pick(valid, t, p, q, c, metric, pus,
                                      warps_per_row, s_round[rb],
                                      BlockBarrier(), any);
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
