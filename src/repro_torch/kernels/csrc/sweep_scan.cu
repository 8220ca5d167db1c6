// The sweep datapath's scan for Hopper (sm_90a): S steps of the PsPIN event
// loop for every replica row of a sweep, in one launch.
//
// Replaces the JAX package's scan of the step (src/repro/sim/devicepath.py,
// `lax.scan` of `_step` inside `jax.jit`), whose WLBVT dispatch is the
// Pallas TPU kernel `_select_kernel` (src/repro/kernels/wlbvt_select.py);
// here that dispatch is wlbvt_round.cuh's `round_pick`, the round
// wlbvt_select.cu runs, inlined into every step.  The plain version is
// kernels/ref.py::sweep_scan_ref (the torch step, ~126 small kernels a
// step); this kernel writes the same [S, R] records and the same final
// state, bit for bit, in float64 and float32, under wlbvt and rr.
//
// A step, for each replica row (kernels/ref.py::sweep_scan_ref says why
// one event a step and one grant an event suffice): take the earlier of the
// next arrival and the earliest PU slot finish (an arrival wins a tie; the
// completing slot is the lowest seq among the slots at the minimum finish);
// past the row's horizon, or with nothing left, the row is dead; else fold
// dt into total_occup, bvt and the Jain integrals; apply the event (FMQ
// push with ECN mark before drop, or a completion freeing its slot); grant
// at most one PU (the WLBVT round, or rr's first non-empty queue at or
// after the pointer); pop the winner's FIFO head, clamp it to the kernel-
// and total-cycle budgets and start it in the first free slot.
//
// Bit exactness against the torch step is the contract:
//   * every float operation goes through the _rn intrinsics in the torch
//     step's order (no product is contracted into an FMA; the build uses
//     IEEE division, no --use_fast_math);
//   * the sums over tenants (the Jain sums, the round's psum) take
//     core/sched_generic.py::lane_sum's tree (wlbvt_round.cuh);
//   * ties break as the torch step breaks them (see above; the granted
//     slot is the first free one, as argmax takes the first maximum).
//
// What bounds it: each row's serial chain of dependent steps, not bytes.  A
// run reads the arrivals once and writes 24 bytes of records a step (the
// mix: ~80 MB over 3.35 TB/s, ~0.024 ms), but a step is a chain of
// shuffle reductions, fp64 divides and a few shared-memory reads that the
// next step depends on.  So the design keeps the chain on chip:
//   * one block a row, one thread a tenant lane and a PU slot: ceil(T/32)
//     warps (one warp up to T 32, four up to T 128), so a row of one warp
//     needs no barrier at all and rows never wait for each other;
//   * every tenant's state (queue length, occupancy, the BVT and occupancy
//     integrals, budgets, spent, its FIFO head packet and cost) and every
//     slot (finish, start, packet meta, seq, tenant) stays in its thread's
//     registers for the whole run; now, na, seq, free PUs, the rr pointer
//     and the Jain integrals are warp-uniform registers;
//   * the arrivals (read once, in order) are staged through shared memory
//     in chunks of one entry a thread; the next chunk's cp.async is in
//     flight while the current one is consumed;
//   * a tenant's FIFO ring is the kernel's own scratch, touched only by its
//     lane: a push writes it, a pop issues the read of the next head at
//     once, so the load is done by the next pop of that tenant;
//   * the records of 32 steps are gathered one a lane and stored together;
//     a row that is dead (drained or past its horizon) stays dead, since its
//     state no longer changes, so it stops and fills its tail with its
//     frozen record.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "wlbvt_round.cuh"

namespace {

using wlbvt::add_rn;
using wlbvt::div_rn;
using wlbvt::kFull;
using wlbvt::kWarp;
using wlbvt::mul_rn;
using wlbvt::sub_rn;

constexpr int kMaxLanes = wlbvt::kMaxLanes;   // tenants and PU slots a row
constexpr int kPkt = (1 << 30) - 1;           // slot meta: pkt | kill<<30 |
constexpr int kKill = 1 << 30;                // budget-kill<<31
constexpr int kBudgetKill = int(0xC0000000u); // bits 30 and 31
constexpr int kSent = INT_MAX;                // seq of a never-used slot

template <typename F>
struct Args {
  // inputs: arrivals [R, NB1]; per tenant [R, T]; per row [R]
  const F* arr_t;
  const long long* arr_tenant;
  const F* arr_comp;
  const F* prio;
  const F* klim;
  const F* tlim;
  const int* fifo_cap;
  const int* ecn_m1;
  const int* n_arr;
  const F* horizon_live;
  // records [S, R]
  int* eq_pack;
  F* ev_t;
  int* comp_meta;
  F* comp_ktime;
  // final state: per row [R], per tenant [R, T]
  F* now;
  long long* na;
  int* seq;
  int* free_pus;
  long long* rr_ptr;
  int* queue_len;
  int* cur_occup;
  F* total_occup;
  F* bvt;
  long long* fifo_head;
  F* spent;
  F* jain_acc;
  F* jain_t;
  // scratch: each tenant's FIFO ring [R, T, C] (packet id, compute cycles)
  int* ring_pkt;
  F* ring_comp;
  int R, T, P, C, S, NB1;
  F dma_ns, ns_per_cycle;
};

struct RowBarrier {   // a block is one row
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (m, k) := the lower of (m, k) and (m2, k2); keys are unique
template <typename F>
__device__ __forceinline__ void take_min_key(F& m, unsigned long long& k, F m2,
                                             unsigned long long k2) {
  if (m2 < m || (m2 == m && k2 < k)) {
    m = m2;
    k = k2;
  }
}

// Cross-warp partials of a row of several warps; each field has its own
// entries, and a step puts barriers between two uses of any of them.
template <typename F>
struct Exchange {
  F slot_m[wlbvt::kMaxRowWarps];
  unsigned long long slot_k[wlbvt::kMaxRowWarps];
  int slot_meta[wlbvt::kMaxRowWarps];
  F slot_t0[wlbvt::kMaxRowWarps];
  int slot_ten[wlbvt::kMaxRowWarps];
  int qa;
  F jain[3][wlbvt::kMaxRowWarps];
  wlbvt::RoundScratch<F> round;
  int rr_min[wlbvt::kMaxRowWarps];
  unsigned free_mask[wlbvt::kMaxRowWarps];
  F pop_comp;
  int pop_meta;
};

template <typename F, int W, bool WLBVT>
__global__ void __launch_bounds__(W * kWarp)
sweep_scan_kernel(const Args<F> a) {
  constexpr int kThreads = W * kWarp;
  constexpr int CH = kThreads;                 // arrivals a staged chunk
  __shared__ F st_t[2][CH];
  __shared__ long long st_ten[2][CH];
  __shared__ F st_comp[2][CH];
  __shared__ Exchange<F> ex;

  const RowBarrier bar;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;                 // tenant lane and PU slot
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int T = a.T, C = a.C, S = a.S, R = a.R;
  const bool ten_ok = tid < T;
  const bool slot_ok = tid < a.P;
  const size_t arow = size_t(r) * a.NB1;
  const size_t toff = size_t(r) * T + tid;
  const size_t ring = (size_t(r) * T + tid) * C;
  const F inf = F(INFINITY);

  // ---- staging of the arrivals: chunk c0 into buffer b ----
  auto stage = [&](int b, int c0) {
    const int i = c0 + tid;
    if (i < a.NB1) {
      cp_async<sizeof(F)>(&st_t[b][tid], a.arr_t + arow + i);
      cp_async<8>(&st_ten[b][tid], a.arr_tenant + arow + i);
      cp_async<sizeof(F)>(&st_comp[b][tid], a.arr_comp + arow + i);
    }
    cp_async_commit();
  };
  stage(0, 0);
  stage(1, CH);

  // ---- the row's state ----
  // tenant lane
  F p = F(1), kl = inf, tl = F(0);
  if (ten_ok) {
    p = a.prio[toff];
    kl = a.klim[toff];
    tl = a.tlim[toff];
  }
  int q = 0, c = 0, head = 0;                  // head: pops so far
  F to = F(0), bv = F(0), sp = F(0);
  int hpkt = 0;                                // FIFO head: packet, cycles
  F hcomp = F(0);
  // PU slot
  F tf = inf, t0 = F(0);
  int meta = 0, sq = kSent, sten = 0;
  // uniform
  F now = F(0), jacc = F(0), jt = F(0);
  int na = 0, seq = a.n_arr[r], nfree = a.P, rr = 0;
  const F hz = a.horizon_live[r];
  const int cap = a.fifo_cap[r], ecn_m1 = a.ecn_m1[r];
  const F dma = a.dma_ns, npc = a.ns_per_cycle, pus = F(a.P);
  // records of steps s0 .. s0 + 31, one a lane (warp 0 stores them)
  int rec_eq = 0, rec_meta = -1;
  F rec_t = F(0), rec_kt = F(0);
  auto flush = [&](int s0, int n) {
    if (warp == 0 && lane < n) {
      const size_t o = size_t(s0 + lane) * R + r;
      a.eq_pack[o] = rec_eq;
      a.ev_t[o] = rec_t;
      a.comp_meta[o] = rec_meta;
      a.comp_ktime[o] = rec_kt;
    }
  };

  cp_async_wait<1>();                          // chunk 0 is in
  __syncthreads();
  int cur = 0, base = 0;                       // st_*[cur] holds base ..
  int s = 0;
  int dead_ten = -1;                           // >= 0: the row died at s
  for (; s < S; ++s) {
    if (na - base == CH) {                     // into the next chunk
      cp_async_wait<0>();
      __syncthreads();
      cur ^= 1;
      base += CH;
      stage(cur ^ 1, base + CH);
    }
    const F ta = st_t[cur][na - base];
    const int ia = int(st_ten[cur][na - base]);
    const F acomp = st_comp[cur][na - base];

    // ---- earliest slot finish: lowest (t_fin, seq, slot) ----
    F tmin = slot_ok ? tf : inf;
    unsigned long long key =
        slot_ok ? (static_cast<unsigned long long>(sq) << 8) | tid : ~0ull;
#pragma unroll
    for (int o = kWarp / 2; o >= 1; o >>= 1) {
      const F m2 = __shfl_xor_sync(kFull, tmin, o);
      const unsigned long long k2 = __shfl_xor_sync(kFull, key, o);
      take_min_key(tmin, key, m2, k2);
    }
    const int wl = int(key & 31);
    int pk = __shfl_sync(kFull, meta, wl);
    F pt0 = __shfl_sync(kFull, t0, wl);
    int ic = __shfl_sync(kFull, sten, wl);
    int qa;
    if constexpr (W == 1) {
      qa = __shfl_sync(kFull, q, ia);
    } else {
      if (lane == 0) {
        ex.slot_m[warp] = tmin;
        ex.slot_k[warp] = key;
        ex.slot_meta[warp] = pk;
        ex.slot_t0[warp] = pt0;
        ex.slot_ten[warp] = ic;
      }
      if (tid == ia) ex.qa = q;
      __syncthreads();
      int best = 0;
      tmin = ex.slot_m[0];
      key = ex.slot_k[0];
      for (int w = 1; w < W; ++w) {
        if (ex.slot_m[w] < tmin || (ex.slot_m[w] == tmin && ex.slot_k[w] < key)) {
          tmin = ex.slot_m[w];
          key = ex.slot_k[w];
          best = w;
        }
      }
      pk = ex.slot_meta[best];
      pt0 = ex.slot_t0[best];
      ic = ex.slot_ten[best];
      qa = ex.qa;
    }
    const int pc = int(key & 0xff);
    const bool is_arr = ta <= tmin;            // arrival seqs < completion seqs
    const F t = is_arr ? ta : tmin;
    if (!(t <= hz)) {                          // drained or past the horizon
      dead_ten = is_arr ? ia : ic;
      break;
    }

    // ---- fold dt over the pre-event state (Simulator._advance_to) ----
    F dt = sub_rn(t, now);
    dt = dt > F(0) ? dt : F(0);
    const bool act = q > 0 || c > 0;           // pad lanes: q = c = 0
    const F actf = act ? F(1) : F(0);
    const F occf = F(c);
    to = add_rn(to, mul_rn(occf, dt));
    bv = add_rn(bv, mul_rn(dt, actf));
    const F x = ten_ok ? div_rn(occf, p) : F(0);
    const F actn = wlbvt::lane_sum(actf, tid, W, ex.jain[0], bar);
    const F s1 = wlbvt::lane_sum(x, tid, W, ex.jain[1], bar);
    const F s2 = wlbvt::lane_sum(mul_rn(x, x), tid, W, ex.jain[2], bar);
    const F jain = s2 > F(0) ? div_rn(mul_rn(s1, s1), mul_rn(actn, s2)) : F(1);
    const F two = actn >= F(2) ? F(1) : F(0);
    jacc = add_rn(jacc, mul_rn(mul_rn(jain, dt), two));
    jt = add_rn(jt, mul_rn(dt, two));

    // ---- apply the event; its EQ code and record ----
    int code, ten, rmeta = -1;
    F rkt = F(0);
    if (is_arr) {                              // FMQ push: admit, drop, mark
      const bool acc = qa < cap;
      code = acc ? (qa >= ecn_m1 ? 1 : 0) : 2;
      if (acc && tid == ia) {
        if (q == 0) {
          hpkt = na;
          hcomp = acomp;
        } else {
          const int w = (head + q) % C;
          a.ring_pkt[ring + w] = na;
          a.ring_comp[ring + w] = acomp;
        }
        q += 1;
      }
      ten = ia;
      na += 1;
    } else {                                   // completion of slot pc
      if (tid == pc) tf = inf;                 // keeps its stale seq
      if (tid == ic) c -= 1;
      nfree += 1;
      code = (pk & kKill) ? (pk < 0 ? 4 : 3) : 0;
      ten = ic;
      rmeta = pk;
      rkt = sub_rn(t, sub_rn(pt0, dma));       // now - (t0 - dma_ns)
    }

    // ---- grant at most one PU ----
    int pick = -1;
    if (WLBVT) {
      const F b1 = bv > F(1) ? bv : F(1);
      const F metric = ten_ok ? div_rn(div_rn(to, b1), p) : F(0);
      bool any;
      const int idx = wlbvt::round_pick(ten_ok, tid, p, q, c, metric, pus, W,
                                        ex.round, bar, any);
      if (any && nfree > 0) pick = idx;
    } else {                                   // first non-empty at/after rr
      int order = T;
      if (ten_ok && q > 0) {
        order = (tid - rr) % T;
        if (order < 0) order += T;
      }
#pragma unroll
      for (int o = kWarp / 2; o >= 1; o >>= 1)
        order = min(order, __shfl_xor_sync(kFull, order, o));
      if constexpr (W > 1) {
        if (lane == 0) ex.rr_min[warp] = order;
        __syncthreads();
        order = ex.rr_min[0];
        for (int w = 1; w < W; ++w) order = min(order, ex.rr_min[w]);
      }
      if (order < T && nfree > 0) {
        pick = (rr + order) % T;
        rr = (pick + 1) % T;
      }
    }

    // ---- pop the winner's FIFO head, clamp it, start it ----
    if (pick >= 0) {
      F comp = F(0);
      int pmeta = 0;
      if (tid == pick) {
        q -= 1;
        c += 1;
        const int j = hpkt;
        comp = hcomp;
        head += 1;
        if (q > 0) {                           // the next head, read now
          const int h = head % C;
          hpkt = a.ring_pkt[ring + h];
          hcomp = a.ring_comp[ring + h];
        }
        const bool kill1 = comp > kl;          // klim is +inf without a limit
        comp = kill1 ? kl : comp;
        const F remaining = sub_rn(tl, sp);
        const bool bk = tl > F(0) && comp > remaining;
        comp = bk ? (remaining > F(0) ? remaining : F(0)) : comp;
        sp = add_rn(sp, mul_rn(comp, F(1)));
        pmeta = bk ? (j | kBudgetKill) : (kill1 ? (j | kKill) : j);
      }
      const unsigned fm = __ballot_sync(kFull, slot_ok && tf == inf);
      int fs;
      if constexpr (W == 1) {
        comp = __shfl_sync(kFull, comp, pick);
        pmeta = __shfl_sync(kFull, pmeta, pick);
        fs = __ffs(fm) - 1;
      } else {
        if (lane == 0) ex.free_mask[warp] = fm;
        if (tid == pick) {
          ex.pop_comp = comp;
          ex.pop_meta = pmeta;
        }
        __syncthreads();
        comp = ex.pop_comp;
        pmeta = ex.pop_meta;
        fs = -1;
        for (int w = W - 1; w >= 0; --w)
          if (ex.free_mask[w]) fs = w * kWarp + __ffs(ex.free_mask[w]) - 1;
      }
      if (tid == fs) {
        t0 = add_rn(t, dma);
        tf = add_rn(t0, mul_rn(comp, npc));
        meta = pmeta;
        sq = seq;
        sten = pick;
      }
      seq += 1;
      nfree -= 1;
    }
    now = t;

    if (lane == (s & 31)) {
      rec_eq = (ten << 3) | code;
      rec_t = t;
      rec_meta = rmeta;
      rec_kt = rkt;
    }
    if ((s & 31) == 31) flush(s - 31, 32);
  }
  flush(s & ~31, s & 31);
  if (dead_ten >= 0) {                         // its frozen record, to the end
    for (int k = s + tid; k < S; k += kThreads) {
      const size_t o = size_t(k) * R + r;
      a.eq_pack[o] = dead_ten << 3;
      a.ev_t[o] = now;
      a.comp_meta[o] = -1;
      a.comp_ktime[o] = F(0);
    }
  }
  cp_async_wait<0>();

  // ---- final state ----
  if (tid == 0) {
    a.now[r] = now;
    a.na[r] = na;
    a.seq[r] = seq;
    a.free_pus[r] = nfree;
    a.rr_ptr[r] = rr;
    a.jain_acc[r] = jacc;
    a.jain_t[r] = jt;
  }
  if (ten_ok) {
    a.queue_len[toff] = q;
    a.cur_occup[toff] = c;
    a.total_occup[toff] = to;
    a.bvt[toff] = bv;
    a.fifo_head[toff] = head;
    a.spent[toff] = sp;
  }
}

template <typename F, bool WLBVT>
int launch(const Args<F>& a, cudaStream_t stream) {
  const int W = (max(a.T, a.P) + kWarp - 1) / kWarp;
  switch (W) {
    case 1: sweep_scan_kernel<F, 1, WLBVT><<<a.R, 1 * kWarp, 0, stream>>>(a); break;
    case 2: sweep_scan_kernel<F, 2, WLBVT><<<a.R, 2 * kWarp, 0, stream>>>(a); break;
    case 3: sweep_scan_kernel<F, 3, WLBVT><<<a.R, 3 * kWarp, 0, stream>>>(a); break;
    default: sweep_scan_kernel<F, 4, WLBVT><<<a.R, 4 * kWarp, 0, stream>>>(a); break;
  }
  return int(cudaGetLastError());
}

template <typename F>
int run(int wlbvt_sched, void* const* p, const long long* d, double dma_ns,
        double ns_per_cycle, cudaStream_t stream) {
  Args<F> a;
  a.arr_t = static_cast<const F*>(p[0]);
  a.arr_tenant = static_cast<const long long*>(p[1]);
  a.arr_comp = static_cast<const F*>(p[2]);
  a.prio = static_cast<const F*>(p[3]);
  a.klim = static_cast<const F*>(p[4]);
  a.tlim = static_cast<const F*>(p[5]);
  a.fifo_cap = static_cast<const int*>(p[6]);
  a.ecn_m1 = static_cast<const int*>(p[7]);
  a.n_arr = static_cast<const int*>(p[8]);
  a.horizon_live = static_cast<const F*>(p[9]);
  a.eq_pack = static_cast<int*>(p[10]);
  a.ev_t = static_cast<F*>(p[11]);
  a.comp_meta = static_cast<int*>(p[12]);
  a.comp_ktime = static_cast<F*>(p[13]);
  a.now = static_cast<F*>(p[14]);
  a.na = static_cast<long long*>(p[15]);
  a.seq = static_cast<int*>(p[16]);
  a.free_pus = static_cast<int*>(p[17]);
  a.rr_ptr = static_cast<long long*>(p[18]);
  a.queue_len = static_cast<int*>(p[19]);
  a.cur_occup = static_cast<int*>(p[20]);
  a.total_occup = static_cast<F*>(p[21]);
  a.bvt = static_cast<F*>(p[22]);
  a.fifo_head = static_cast<long long*>(p[23]);
  a.spent = static_cast<F*>(p[24]);
  a.jain_acc = static_cast<F*>(p[25]);
  a.jain_t = static_cast<F*>(p[26]);
  a.ring_pkt = static_cast<int*>(p[27]);
  a.ring_comp = static_cast<F*>(p[28]);
  a.R = int(d[0]);
  a.T = int(d[1]);
  a.P = int(d[2]);
  a.C = int(d[3]);
  a.S = int(d[4]);
  a.NB1 = int(d[5]);
  a.dma_ns = F(dma_ns);
  a.ns_per_cycle = F(ns_per_cycle);
  return wlbvt_sched ? launch<F, true>(a, stream) : launch<F, false>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64 (every float array); wlbvt: 1 = WLBVT,
// 0 = rr.  ptrs, 29 device pointers in this order: arr_t, arr_tenant
// (int64), arr_comp [R, NB1]; prio, klim, tlim [R, T]; fifo_cap, ecn_m1,
// n_arr (int32), horizon_live [R]; the records eq_pack (int32), t,
// comp_meta (int32), comp_ktime [S, R]; the final state now, na (int64),
// seq, free_pus (int32), rr_ptr (int64) [R], queue_len, cur_occup
// (int32), total_occup, bvt, fifo_head (int64), spent [R, T], jain_acc,
// jain_t [R]; the scratch rings ring_pkt (int32), ring_comp [R, T, C].
// dims: R, T, P, C, S, NB1.  All contiguous.  Returns the cudaError_t of
// the launch (0 = success).
int sweep_scan(int dtype, int wlbvt_sched, void* const* ptrs,
               const long long* dims, double dma_ns, double ns_per_cycle,
               void* stream) {
  const long long R = dims[0], T = dims[1], P = dims[2], C = dims[3],
                  S = dims[4], NB1 = dims[5];
  if (R < 0 || T < 1 || T > kMaxLanes || P < 1 || P > kMaxLanes || C < 1 ||
      S < 0 || NB1 < 1 || R > INT_MAX || S > INT_MAX || NB1 > kPkt)
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(wlbvt_sched, ptrs, dims, dma_ns, ns_per_cycle, s);
  if (dtype == 1)
    return run<double>(wlbvt_sched, ptrs, dims, dma_ns, ns_per_cycle, s);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
