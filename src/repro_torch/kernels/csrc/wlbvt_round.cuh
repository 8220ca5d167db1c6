// The WLBVT dispatch round, one definition for every kernel that runs it:
// `wlbvt_select.cu` (a standalone round of up to 128 picks) and
// `sweep_scan.cu` (one pick in each step of the sweep's scan).
//
// One pick over the tenant lanes of one replica row, thread t of the row
// holding lane t (valid when t < T): the sum of the priorities of the
// non-empty queues, taken in core/sched_generic.py::lane_sum's order;
// pu_limit = ceil(P * prio / max(psum, 1e-9) - 1e-6) (P when no queue is
// non-empty); a lane is eligible when ql > 0 and co < pu_limit; the pick
// is the first argmin of the eligible metrics (BIG = 1e30 elsewhere).
// Bit for bit the plain version's (kernels/ref.py::_one_pick):
//   * every product and quotient is written with the _rn intrinsics, so
//     no multiply is contracted into an FMA; the build uses IEEE division
//     (no --use_fast_math);
//   * lane_sum's order: a halving tree inside each warp of 32 lanes (zero
//     padded; a shuffle butterfly leaves the same sum in every lane, since
//     each node adds the same two halves), then the warps left to right;
//   * the argmin is a shuffle min over (metric, lane) pairs in which the
//     lower lane wins a tie, as argmin's first index does.
// A row of one warp needs no shared memory and no barrier; a row of
// ceil(T/32) warps passes each warp's partial through shared memory
// between the row's barriers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wlbvt {

constexpr int kWarp = 32;
constexpr int kMaxLanes = 128;       // tenant lanes of a row: four warps
constexpr int kMaxRowWarps = kMaxLanes / kWarp;
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

// One row's cross-warp partials (used only when the row has several warps).
template <typename F>
struct RoundScratch {
  F sum[kMaxRowWarps];
  F min[kMaxRowWarps];
  int idx[kMaxRowWarps];
  int any[kMaxRowWarps];
};

// Sum of v over the row's lanes in lane_sum's order; every thread of the row
// returns it.  t: the thread's lane in the row; warps: the row's warps;
// part: one entry per warp; bar(): the row's barrier.  The caller puts a
// barrier of the row between two uses of the same `part`.
template <typename F, typename Barrier>
__device__ __forceinline__ F lane_sum(F v, int t, int warps, F* part,
                                      const Barrier& bar) {
#pragma unroll
  for (int o = kWarp / 2; o >= 1; o >>= 1)
    v = add_rn(v, __shfl_xor_sync(kFull, v, o));
  if (warps == 1) return v;
  if (t % kWarp == 0) part[t / kWarp] = v;
  bar();
  F s = part[0];
  for (int w = 1; w < warps; ++w) s = add_rn(s, part[w]);
  return s;
}

// One pick.  valid: t < T; p, q, c: the lane's prio, queue length and
// occupancy; metric: (total_occup / max(bvt, 1)) / prio; pus: P.  Returns
// the first argmin lane (uniform over the row) and sets `any` when some lane
// is eligible; the caller decides whether the pick is granted.
template <typename F, typename Barrier>
__device__ __forceinline__ int round_pick(bool valid, int t, F p, int q, int c,
                                          F metric, F pus, int warps,
                                          RoundScratch<F>& s,
                                          const Barrier& bar, bool& any) {
  const F big = F(1e30), eps = F(1e-6), tiny = F(1e-9);
  const F psum = lane_sum((valid && q > 0) ? p : F(0), t, warps, s.sum, bar);
  const F lim = psum > F(0)
      ? ceil_(sub_rn(div_rn(mul_rn(pus, p), psum > tiny ? psum : tiny), eps))
      : pus;
  const bool elig = valid && q > 0 && F(c) < lim;
  // pad lanes never win
  F m = valid ? (elig ? metric : big) : F(INFINITY);
  int idx = valid ? t : kMaxLanes;
#pragma unroll
  for (int o = kWarp / 2; o >= 1; o >>= 1) {
    const F m2 = __shfl_xor_sync(kFull, m, o);
    const int i2 = __shfl_xor_sync(kFull, idx, o);
    take_min(m, idx, m2, i2);
  }
  int any_w = __any_sync(kFull, elig);
  if (warps > 1) {
    const int w = t / kWarp;
    if (t % kWarp == 0) {
      s.min[w] = m;
      s.idx[w] = idx;
      s.any[w] = any_w;
    }
    bar();
    m = s.min[0];
    idx = s.idx[0];
    any_w = s.any[0];
    for (int k = 1; k < warps; ++k) {
      take_min(m, idx, s.min[k], s.idx[k]);
      any_w |= s.any[k];
    }
  }
  any = any_w != 0;
  return idx;
}

}  // namespace wlbvt
