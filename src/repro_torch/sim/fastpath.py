"""Array-batched simulator fast path (DESIGN.md §8).

``BatchedSimulator`` is a drop-in replacement for the event-loop
``Simulator`` that makes the same scheduling decisions — pinned
bit-for-bit by the sim-level golden trace and the cross-path property
tests — at a large multiple of the packet rate.  Three mechanisms:

  * **SoA packet store** — the trace lives as flat arrays
    (``TraceArrays``): per-packet payloads, compute cycles and IO bytes
    are derived in one vectorized pass at injection instead of one
    ``WorkloadModel`` call per packet; queued packets are integer
    indices into the (append-only) store, in-flight kernels a fixed
    ``num_pus``-row slot table (tenant, packet, t0, kill flags, IO
    bytes).

  * **Window-batched arrivals** — while every PU is busy an arrival
    cannot trigger a dispatch; it only stages bookkeeping.  All such
    arrivals up to the next decision point (kernel completion, IO
    grant, control event or telemetry-window boundary — and never past
    a change of the WLBVT active set) are applied in one vectorized
    pass: FMQ depth/ECN/drop classification, queue-length, stats and
    telemetry counters.  EQ events still materialize per packet in
    exact chronological order (lazily — see ``BlockEventLog``).

  * **Typed event records** — the retained heapq holds plain
    ``(time, seq, code, payload)`` tuples (no per-event closures) and is
    reserved for decision-bearing events: kernel completions, AXI/egress
    grants and control traffic.

Exactness: WLBVT virtual time is integrated with the *same* per-event
fold the event loop performs — scalar intervals reuse the identical
masked ``+= x*dt`` adds, and batches fold through ``np.cumsum``, whose
sequential left-to-right accumulation is IEEE-identical to the
per-event adds.  Scheduling decisions reuse the exact ``sched_generic``
formulas (same masked-argmin tie-breaks as ``select_k``); the per-round
``pu_limit`` is cached and invalidated only when the non-empty FMQ set
or the live priorities change — the same incremental-maintenance
argument ``select_k`` already relies on.  The only quantity that is
mathematically but not bit-wise identical is the Jain *time-integral*
(its moments are delta-maintained and re-derived every telemetry
window; DESIGN.md §8 quantifies the bounded fold drift).
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.core import Event, EventKind, fragment_transfer
from repro_torch.core import sched_generic as G
from repro_torch.core.accounting import jain_fairness
from repro_torch.core.engine_base import BudgetLedger
from repro_torch.core import wlbvt as W
from repro_torch.sim.engine import KT_RESERVOIR_CAP, SimResult, Simulator
from repro_torch.sim.traffic import TraceArrays
from repro_torch.telemetry import trace as TR
from repro_torch.telemetry.metrics import C_IDX

MAX_BATCH = 8192        # arrival-batch cap (bounds the fold buffer)
SMALL_BATCH = 4         # below this, scalar folds beat the vector machinery
_INF = float("inf")

class BlockEventLog:
    """Shared-queue EQ log with block pushes and lazy materialization.

    Drop storms push thousands of EQ events per arrival batch, but only
    the last ``capacity`` ever survive to ``drain_all`` (ring
    semantics).  This log stores whole batches as numpy column blocks —
    O(1) python work per batch — and materializes ``Event`` objects only
    for the retained window.  Drained content and the ``dropped``
    counter are identical to an ``EventQueue`` of the same capacity fed
    one ``push`` per event.
    """

    #: small-int kind codes blocks may carry instead of EventKind objects
    CODE_KINDS = {1: EventKind.ECN_MARK, 2: EventKind.QUEUE_OVERFLOW}

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._blocks: deque = deque()   # (tenants, kinds, times) seqs
        self._len = 0
        self.dropped = 0

    def __len__(self) -> int:
        return self._len

    def push(self, ev: Event) -> None:
        self.push_raw(ev.tenant, ev.kind, ev.time, ev.detail)

    def push_raw(self, tenant: int, kind, time: float,
                 detail: str = "") -> None:
        if detail:
            kind = (kind, detail)       # rare: carry detail through
        self._blocks.append(((tenant,), (kind,), (time,)))
        self._advance_len(1)

    def push_block(self, tenants, kinds, times) -> None:
        """One batch of events, chronological: parallel sequences (numpy
        arrays or lists) of tenant ids, ``EventKind``s and times."""
        n = len(tenants)
        if n == 0:
            return
        self._blocks.append((tenants, kinds, times))
        self._advance_len(n)

    def _advance_len(self, n: int) -> None:
        self._len += n
        # evict whole leading blocks once they cannot intersect the
        # retained window (bounds memory; partial eviction at drain)
        while self._blocks and (self._len - len(self._blocks[0][0])
                                >= self.capacity):
            blk = self._blocks.popleft()
            k = len(blk[0])
            self._len -= k
            self.dropped += k

    def _materialize(self) -> tuple:
        out: List[Event] = []
        for tenants, kinds, times in self._blocks:
            if isinstance(tenants, np.ndarray):
                tenants = tenants.tolist()
            if isinstance(times, np.ndarray):
                times = times.tolist()
            if isinstance(kinds, np.ndarray):
                km = self.CODE_KINDS
                kinds = [km[k] for k in kinds.tolist()]
            for t, k, tm in zip(tenants, kinds, times):
                if type(k) is tuple:
                    out.append(Event(t, k[0], tm, k[1]))
                else:
                    out.append(Event(t, k, tm))
        over = len(out) - self.capacity
        if over > 0:
            return out[over:], over
        return out, 0

    def drain_all(self) -> List[Event]:
        out, over = self._materialize()
        self.dropped += over            # partial-window evictions
        self._blocks.clear()
        self._len = 0
        return out

    def snapshot(self, tenant: Optional[int] = None) -> List[Event]:
        evs, _ = self._materialize()    # non-destructive
        return (evs if tenant is None
                else [e for e in evs if e.tenant == tenant])


# typed heap event codes (heap entries: (time, seq, code, payload))
K_FIN = 0      # kernel finished, no IO     payload: slot
K_SUBMIT = 1   # compute done, submit IO    payload: slot
K_AXI = 2      # AXI transfer done          payload: (tenant, frag, kind, cb)
K_EGR = 3      # egress transfer done       payload: (tenant, frag, cb)
K_CTRL = 4     # control message done       payload: user cb | None

# callback codes (cb above): None | ("fin", slot) | ("sw", rec) | callable


class BatchedSimulator(Simulator):
    """Same construction surface and semantics as ``Simulator``; the
    data plane is array-batched (DESIGN.md §8)."""

    def __init__(self, tenants, **kw):
        super().__init__(tenants, **kw)
        T = len(tenants)
        self._T = T
        hw = self.hw
        # SoA FMQ FIFOs: per-tenant deques of packet indices + depth array
        self._fifo: List[deque] = [deque() for _ in range(T)]
        self._fifo_len = np.zeros(T, np.int64)
        self._fifo_cap = np.array([f.capacity for f in self.fmqs], np.int64)
        self._ecn_thresh = np.array([f.ecn_threshold for f in self.fmqs],
                                    np.int64)
        self._fifo_cap_l = self._fifo_cap.tolist()
        self._ecn_thresh_l = self._ecn_thresh.tolist()
        # staged-counter column views (the numpy telemetry backend zeroes
        # the staging array in place, so these stay valid across commits)
        self._st_arrivals = self.tel._staged_counts[:, C_IDX["arrivals"]]
        self._st_bytes_in = self.tel._staged_counts[:, C_IDX["bytes_in"]]
        self._st_drops = self.tel._staged_counts[:, C_IDX["drops"]]
        # bound append on the staged-latency list (commit clears the
        # list in place, so the binding survives) — tel.lat minus two
        # attribute lookups per completion
        self._lat_append = self.tel._staged_lat.append
        # per-tenant workload/SLO parameter rows (vectorized cost models)
        wls = [e.kernel for e in tenants]
        self._wl_spin = np.array([w.spin_factor if w else 1.0 for w in wls])
        self._wl_base = np.array([w.compute_base if w else 0.0 for w in wls])
        self._wl_cpb = np.array([w.compute_per_byte if w else 0.0
                                 for w in wls])
        self._wl_iofix = np.array([w.io_fixed_bytes if w else 0
                                   for w in wls], np.int64)
        self._wl_iofac = np.array([w.io_bytes_factor if w else 0.0
                                   for w in wls])
        self._wl_io_none = np.array([(w.io_kind == "none") if w else True
                                     for w in wls])
        self._wl_io_kind = [w.io_kind if w else "none" for w in wls]
        self._kern_limit = [e.slo.kernel_cycle_limit for e in tenants]
        self._total_limit = [e.slo.total_cycle_limit for e in tenants]
        # in-flight kernel slot table (<= num_pus rows; plain lists —
        # access is purely scalar and list indexing is ~3x cheaper)
        P = hw.num_pus
        self._num_pus = P            # hoisted: hw.num_pus is a property
        self._s_tenant = [0] * P
        self._s_pkt = [0] * P
        self._s_t0 = [0.0] * P
        self._s_killed = [False] * P
        self._s_bkilled = [False] * P
        self._s_payload = [0] * P
        self._s_io = [0] * P
        self._free_slots = list(range(P - 1, -1, -1))
        # tracing-only slot columns + packet-index -> uid lookup (uids
        # are assigned in arrival-processing order, matching the event
        # loop's per-_arrival counter)
        if self.trace is not None:
            self._s_uid = [0] * P
            self._s_grant = [0.0] * P
            self._s_tcomp = [0.0] * P
            self._tr_uid_arr = np.empty(0, np.int64)
            self._tr_adisp = np.empty(0, np.int8)  # ARRIVE disposition
        # append-only packet store (indices stay valid across injections);
        # columns read only scalar at dispatch time are plain lists
        self._p_t = np.empty(0)
        self._p_seq = np.empty(0, np.int64)
        self._p_tenant = np.empty(0, np.int64)
        self._p_size = np.empty(0, np.int64)
        self._p_tenant_l: list = []
        self._p_size_l: list = []
        self._p_payload: list = []
        self._p_comp: list = []
        self._p_io: list = []
        # pending arrivals: store indices in (time, seq) order + cursor;
        # list mirrors serve the scalar hot loop, arrays the batch math
        self._order = np.empty(0, np.int64)
        self._ord_t = np.empty(0)
        self._ord_t_l: list = []
        self._ord_seq_l: list = []
        self._ord_j_l: list = []
        self._cursor = 0
        # cached per-round WLBVT limit + eligibility mask (invalidated on
        # non-empty-set or priority changes — same incremental argument as
        # select_k; between rebuilds only the picked/finished tenant's own
        # eligibility bit can change, and it is patched scalar)
        self._limit = None
        self._limit_l: list = [0.0] * T
        self._limit_dirty = True
        self._elig = np.zeros(T, bool)
        self._elig_n = 0
        self._elig_one = -1
        self._rb_metric = np.empty(T)
        self._rb_masked = np.empty(T)
        self._rb_mask = np.empty(T, bool)
        self._rb_mask2 = np.empty(T, bool)
        # bvt is monotone non-decreasing and frozen at 0 until first
        # active: once every tenant's bvt >= 1, max(bvt, 1) is the
        # identity and the metric drops one ufunc (checked per window)
        self._bvt_all_ge1 = False
        # incrementally-maintained mirrors of st.active (bool, so exact)
        # and the masked occupancy/active floats the advance fold uses —
        # stacked (2, T) so one multiply serves both integrals
        self._act = np.zeros(T, bool)
        self._act_n = 0
        self._advA = np.zeros((2, T))
        self._occF_act = self._advA[0]       # where(act, occ, 0) as float
        self._act_f = self._advA[1]          # act as float
        self._adv_buf = np.zeros((2, T))
        # total_occup/bvt re-tied as rows of one (2, T) array so the
        # per-event advance fold is a single stacked += (the event loop's
        # two masked adds, same values — see _advance_to override)
        self._ob = np.stack([self.st.total_occup, self.st.bvt])
        self.st.total_occup = self._ob[0]
        self.st.bvt = self._ob[1]
        # Jain integrand: incremental moments S1=Σx, S2=Σx² over
        # x = occ/prio of active tenants, delta-updated per occupancy
        # change and re-derived vectorized at every window commit (so
        # float drift is bounded to one window).  The integrand value is
        # mathematically identical to the event loop's per-event
        # jain_fairness; only the float fold differs (DESIGN.md §8).
        self._jx = [0.0] * T
        self._jS1 = 0.0
        self._jS2 = 0.0
        self._prio_l = [float(p) for p in self.st.prio]
        self._jain_cache: Optional[float] = None
        # work-skipping gates
        self._fa_left = T                    # tenants with no arrival yet
        self._admit_all = True               # refreshed at window commits
        self._jr_count = 0                   # windows since jain refresh
        self._horizon: Optional[float] = None
        self._kind_lut = np.zeros(T, np.int8)
        self._kind2 = np.full(MAX_BATCH, 2, np.int8)   # all-drop blocks
        # vector accumulators for per-tenant object counters the engine
        # never reads mid-run (TenantStats.drops, FMQ drops/marks/
        # enqueued) — flushed into the objects at the end of run()
        self._acc_drops = np.zeros(T, np.int64)
        self._acc_fmq_drops = np.zeros(T, np.int64)
        self._acc_marks = np.zeros(T, np.int64)
        self._acc_enq = np.zeros(T, np.int64)
        # scalar-hot-path accumulators (plain Python lists: one list
        # store instead of one numpy scalar-indexed add per event).
        # Telemetry counter stages flush at every window commit — the
        # committed per-window values are identical to per-event inc
        # calls; stats/FMQ/budget mirrors flush at the end of run().
        self._tc_names = ("arrivals", "bytes_in", "completed", "bytes_out")
        self._tc = {n: [0.0] * T for n in self._tc_names}
        self._tc_dirty = {n: False for n in self._tc_names}
        self._c_completed = [0] * T
        self._c_served = [0.0] * T
        self._c_lastcomp = [0.0] * T
        self._c_fmqcomp = [0] * T
        self._spent = [0.0] * T              # BudgetLedger.spent mirror
        # kernel-time samples buffered per tenant and replayed into the
        # TenantStats reservoir at flush: below the cap the fill is one
        # vectorized copy, above it the per-sample Algorithm R replay
        # consumes the identical rng stream — reservoir state, count and
        # sum are bit-identical to per-completion record_kernel_time
        self._kt_pend: List[list] = [[] for _ in range(T)]
        self._fold_buf: Optional[np.ndarray] = None   # (MAX_BATCH+1, 2T)
        # block-based EQ log (same ring semantics, O(1) per batch) —
        # replaces the EngineBase EQHub after tenant registration
        self.eqhub = BlockEventLog(capacity=4096)

    # ------------------------------------------------------------------
    # injection: vectorized per-packet derivations
    # ------------------------------------------------------------------
    def _inject(self, trace) -> None:
        if isinstance(trace, TraceArrays):
            ta = trace
        elif len(trace) == 0:
            return
        else:
            ta = TraceArrays.from_packets(trace)
        n = len(ta)
        if n == 0:
            return
        base = self._p_t.shape[0]
        seqs = self._seq + np.arange(n, dtype=np.int64)
        self._seq += n                      # mirrors one _post per arrival
        tn, sz = ta.tenants, ta.sizes
        payload = np.maximum(0, sz - self.hw.header_bytes)
        # same float ops as the scalar WorkloadModel methods, elementwise
        comp = self._wl_spin[tn] * (self._wl_base[tn]
                                    + self._wl_cpb[tn] * payload)
        scaled = (self._wl_iofac[tn] * payload).astype(np.int64)
        io = np.where(self._wl_iofix[tn] > 0, self._wl_iofix[tn], scaled)
        io = np.where(self._wl_io_none[tn], 0, io)
        self._p_t = np.concatenate([self._p_t, ta.times])
        self._p_seq = np.concatenate([self._p_seq, seqs])
        self._p_tenant = np.concatenate([self._p_tenant, tn])
        self._p_size = np.concatenate([self._p_size, sz])
        self._p_tenant_l.extend(tn.tolist())
        self._p_size_l.extend(sz.tolist())
        self._p_payload.extend(payload.tolist())
        self._p_comp.extend(comp.tolist())
        self._p_io.extend(io.tolist())
        if self.trace is not None:
            self._tr_uid_arr = np.concatenate(
                [self._tr_uid_arr, np.full(n, -1, np.int64)])
            self._tr_adisp = np.concatenate(
                [self._tr_adisp, np.full(n, TR.D_OK, np.int8)])
        # merge the not-yet-arrived tail with the new packets, in the
        # exact heap order the event loop would pop: (time, seq)
        merged = np.concatenate([self._order[self._cursor:],
                                 base + np.arange(n, dtype=np.int64)])
        key_t = self._p_t[merged]
        key_s = self._p_seq[merged]
        merged = merged[np.lexsort((key_s, key_t))]
        self._order = merged
        self._ord_t = self._p_t[merged]
        self._ord_t_l = self._ord_t.tolist()
        self._ord_seq_l = self._p_seq[merged].tolist()
        self._ord_j_l = merged.tolist()
        self._cursor = 0

    # ------------------------------------------------------------------
    # time advancement: the same fold as Simulator._advance_to, applied
    # only over intervals that cannot cross a telemetry-window boundary
    # ------------------------------------------------------------------
    def _jain_cur(self) -> float:
        """Jain's index over x = (occ/prio) of the active set, from the
        incremental moments: (Σx)²/(n·Σx²), 1.0 when the set is empty or
        all-zero — the same definition ``accounting.jain_fairness``
        evaluates per event on the event path (value equal up to the
        bounded fold drift of the moments)."""
        if self._jain_cache is None:
            if self._jS1 == 0.0 or self._jS2 <= 0.0:
                self._jain_cache = 1.0
            else:
                self._jain_cache = (self._jS1 * self._jS1
                                    / (self._act_n * self._jS2))
        return self._jain_cache

    def _jain_upd(self, i: int, x: float) -> None:
        """Delta-update the Jain moments after tenant ``i``'s
        priority-normalized occupancy changed to ``x``."""
        old = self._jx[i]
        self._jS1 += x - old
        self._jS2 += x * x - old * old
        self._jx[i] = x
        self._jain_cache = None

    def _jain_refresh(self) -> None:
        """Re-derive the moments vectorized (window commits: bounds the
        incremental fold drift and absorbs controller prio changes)."""
        st = self.st
        x = np.where(self._act, st.cur_occup / st.prio, 0.0)
        self._jx = x.tolist()
        self._jS1 = float(x.sum())
        self._jS2 = float(np.square(x).sum())
        self._prio_l = [float(p) for p in st.prio]
        self._jain_cache = None

    def _advance_small(self, t: float) -> None:
        """The advance fold for an interval known to stay inside the
        current telemetry window: ``total_occup``/``bvt`` get the event
        loop's identical masked ``+= x*dt`` adds as one stacked multiply
        + add on the ``(2, T)`` store, the Jain integral the incremental
        ``+= j*dt``.  ``_win_act`` catch-up is deferred to the next
        boundary-crossing ``_advance_to`` (the active set cannot have
        changed in between; deactivations patch it eagerly)."""
        dt = t - self._last_adv
        if dt <= 0:
            return
        np.multiply(self._advA, dt, out=self._adv_buf)
        self._ob += self._adv_buf
        if self._act_n >= 2:
            self._jain_pu_acc += self._jain_cur() * dt
            self._jain_pu_t += dt
        self._last_adv = t

    def _advance_to(self, t: float) -> None:
        """The event loop's ``_advance_to`` on the stacked store: the
        same masked integration adds (see ``_advance_small``), with the
        window machinery — IO-fairness sample, timeline row, telemetry
        commit, ``_win_act`` catch-up — run only when ``t`` reaches a
        window boundary.  The Jain PU integrand comes from the
        incremental moments instead of a fresh ``jain_fairness`` call
        (value equal up to the bounded fold drift, DESIGN.md §8)."""
        dt = t - self._last_adv
        if dt <= 0:
            return
        np.multiply(self._advA, dt, out=self._adv_buf)
        self._ob += self._adv_buf
        if self._act_n >= 2:
            self._jain_pu_acc += self._jain_cur() * dt
            self._jain_pu_t += dt
        self._last_adv = t
        if t - self._win_start >= self.io_window_ns:
            self._win_act |= self._act
            occ = self.st.cur_occup.astype(float)
            while t - self._win_start >= self.io_window_ns:
                wa = self._win_act
                if wa.sum() >= 2 and self._win_io.sum() > 0:
                    dma_w = np.array([f.ectx.slo.dma_priority
                                      for f in self.fmqs])
                    w = dma_w * self.io_demand_weights
                    self._jain_io_acc += jain_fairness(
                        (self._win_io / w)[wa]) * self.io_window_ns
                    self._jain_io_t += self.io_window_ns
                if self.record_timeline:
                    self._tl["t"].append(self._win_start)
                    self._tl["occup"].append(occ.copy())
                    self._tl["io_win"].append(self._win_io.copy())
                    self._tl["qlen"].append(self.st.queue_len.copy())
                self._commit_window(occ)
                self._win_io[:] = 0.0
                self._win_act = self._act.copy()
                self._win_start += self.io_window_ns

    _advance = _advance_to

    def _deactivate(self, i: int) -> None:
        """Tenant left the active set (occupancy and queue both zero).
        Patch ``_win_act`` eagerly: the event loop's per-event ``|=``
        would have recorded it active earlier this window."""
        self._win_act[i] = True
        self._act[i] = False
        self._act_n -= 1
        self._act_f[i] = 0.0
        self._occF_act[i] = 0.0
        if self._elig[i]:              # queue empty => never eligible
            self._elig[i] = False
            self._elig_n -= 1
            if self._elig_n == 1:
                self._elig_one = -1
        old = self._jx[i]
        self._jS1 -= old
        self._jS2 -= old * old
        self._jx[i] = 0.0
        self._jain_cache = None

    def drain_tenant_queue(self, tenant: int) -> List[tuple]:
        """Live-migration drain — the SoA twin of the event engine's
        version: the queued packet-store indices are resolved back to
        ``(arrival_ns, size_bytes)`` rows (identical values, identical
        FIFO order), then the incremental caches are patched the same
        way a normal queue-empty transition patches them."""
        q = self._fifo[tenant]
        out = [(float(self._p_t[j]), int(self._p_size_l[j])) for j in q]
        q.clear()
        if out:
            self._fifo_len[tenant] = 0
            self.st.queue_len[tenant] -= len(out)
            if self.st.cur_occup[tenant] == 0 and self._act[tenant]:
                self._deactivate(tenant)
            self._limit_dirty = True
        return out

    # ------------------------------------------------------------------
    # WLBVT decisions: same formulas, cached pu_limit
    # ------------------------------------------------------------------
    def _rebuild_elig(self) -> None:
        """Recompute the WLBVT limit + eligibility mask from scratch —
        on the same triggers ``select_k``'s rebuild fires on (non-empty
        set changed, controller moved prio)."""
        st = self.st
        self._limit = G.pu_limit(st.prio, st.queue_len, self.hw.num_pus, np)
        self._limit_l = self._limit.tolist()
        np.greater(st.queue_len, 0, out=self._rb_mask)
        np.less(st.cur_occup, self._limit, out=self._rb_mask2)
        np.logical_and(self._rb_mask, self._rb_mask2, out=self._elig)
        n = int(np.count_nonzero(self._elig))
        self._elig_n = n
        self._elig_one = int(np.argmax(self._elig)) if n == 1 else -1
        self._limit_dirty = False

    def _wlbvt_round(self, k: int) -> List[int]:
        """The k winners of one round — value-identical to
        ``W.select_k`` (same masked argmin over the same metric).

        The eligibility mask (and its popcount) is carried *across*
        rounds: between rebuild triggers only the picked/finished
        tenant's own bit can change and it is patched scalar at those
        events.  With exactly one eligible tenant — the flood steady
        state, where each completion re-enables only the tenant that
        freed the PU — the argmin is forced and the metric is never
        computed; the metric, when needed, is computed once per round
        (it depends only on ``total_occup/bvt/prio``, which no pick
        changes — the same hoisting ``select_k`` does)."""
        st = self.st
        if self._limit_dirty:
            self._rebuild_elig()
        picks: List[int] = []
        ql, co = st.queue_len, st.cur_occup
        masked = None
        for _ in range(k):
            n_el = self._elig_n
            if n_el == 0:
                break
            if n_el == 1 and masked is None:
                i = self._elig_one
                if i < 0:
                    i = int(np.argmax(self._elig))
                    self._elig_one = i
            else:
                if masked is None:
                    metric = self._rb_metric
                    if self._bvt_all_ge1:   # max(bvt, 1) is the identity
                        np.divide(st.total_occup, st.bvt, out=metric)
                    else:
                        np.maximum(st.bvt, 1.0, out=metric)
                        np.divide(st.total_occup, metric, out=metric)
                    np.divide(metric, st.prio, out=metric)
                    masked = self._rb_masked
                    masked.fill(G.BIG)
                    np.copyto(masked, metric, where=self._elig)
                i = int(masked.argmin())
                if masked[i] >= G.BIG:
                    break
            ql[i] -= 1
            co[i] += 1
            o = int(co[i])
            self._occF_act[i] = o
            self._jain_upd(i, o / self._prio_l[i])
            picks.append(i)
            if ql[i] == 0:          # non-empty set shrank: limits change
                self._rebuild_elig()
                masked = None       # mask stale; the metric is not
            elif o >= self._limit_l[i]:
                self._elig[i] = False
                self._elig_n -= 1
                if self._elig_n == 1:
                    self._elig_one = -1
                if masked is not None:
                    masked[i] = G.BIG
        return picks

    def _dispatch(self) -> None:
        tr = self.trace
        if self.sched_kind == "rr":
            while self.free_pus > 0:
                idx, self.rr_ptr = W.select_rr(self.rr_ptr,
                                               self.st.queue_len)
                if idx < 0:
                    return
                if tr is not None:
                    TR.record_rr_pick(tr, self.now, TR.K_PU_RR, idx,
                                      self.st.queue_len, self.st.bvt)
                self.st.queue_len[idx] -= 1
                self.st.cur_occup[idx] += 1
                self._occF_act[idx] = self.st.cur_occup[idx]
                self._jain_upd(idx, self.st.cur_occup[idx]
                               / self._prio_l[idx])
                self._pop_and_start(idx)
            return
        if self.free_pus <= 0:
            return
        if tr is None:
            for idx in self._wlbvt_round(self.free_pus):
                self._pop_and_start(idx)
            return
        # provenance: stage picks + post-round state (the round charges
        # queue_len/cur_occup in place; commit reconstructs the pre-round
        # arrays) — identical records to the event loop because the
        # picks are pinned bit-identical
        picks = self._wlbvt_round(self.free_pus)
        TR.record_wlbvt_round(tr, self.now, self.st, picks,
                              self._num_pus, TR.K_PU_WLBVT)
        for idx in picks:
            self._pop_and_start(idx)

    def _commit_window(self, occ: np.ndarray) -> None:
        self._flush_tc()             # staged counters land in this window
        super()._commit_window(occ)
        if self.controller is not None:
            self._limit_dirty = True   # the controller may have moved prio
            self._jain_refresh()
            self._admit_all = bool(self._admit.all())
        else:
            # static prios/admission: the incremental caches stay valid;
            # re-derive the Jain moments every few windows so the fold
            # drift stays bounded (DESIGN.md §8)
            self._jr_count += 1
            if self._jr_count >= 16:
                self._jr_count = 0
                self._jain_refresh()
        if not self._bvt_all_ge1:    # bvt is monotone: latches True
            self._bvt_all_ge1 = bool((self.st.bvt >= 1.0).all())

    def _flush_tc(self) -> None:
        """Fold the python-list counter accumulators into the telemetry
        staging area (same committed per-window values as per-event
        ``inc`` calls — integer-valued float sums are exact)."""
        d = self._tc_dirty
        for n in self._tc_names:
            if d[n]:
                self.tel.inc_column(n, self._tc[n])
                self._tc[n] = [0.0] * self._T
                d[n] = False

    def _kv_pressure_row(self) -> np.ndarray:
        return self._fifo_len / self._fifo_cap

    # ------------------------------------------------------------------
    # kernel start/finish on the slot table
    # ------------------------------------------------------------------
    def _pop_and_start(self, idx: int) -> None:
        j = self._fifo[idx].popleft()
        self._fifo_len[idx] -= 1
        self.free_pus -= 1
        t0 = self.now + self.hw.cycles_ns(self.hw.dma_setup_cycles)
        comp = self._p_comp[j]
        # budget clamps, inlined on the python-float spend mirror —
        # identical op sequence to BudgetLedger.clamp_kernel/clamp_total
        # (the mirror is flushed into the ledger at the end of run())
        lim = self._kern_limit[idx]
        killed = False
        if lim and comp > lim:
            comp = float(lim)
            killed = True
        tlim = self._total_limit[idx]
        budget_killed = False
        if tlim:
            remaining = float(tlim) - self._spent[idx]
            if comp > remaining:
                budget_killed = killed = True
                comp = remaining if remaining > 0.0 else 0.0
        self._spent[idx] += comp
        io_bytes = 0 if killed else self._p_io[j]
        if io_bytes and self.frag.mode == "software":
            nfrag = -(-io_bytes // self.frag.fragment_bytes)
            comp += self.frag.sw_overhead_cycles * nfrag
        slot = self._free_slots.pop()
        self._s_tenant[slot] = idx
        self._s_pkt[slot] = j
        self._s_t0[slot] = t0
        self._s_killed[slot] = killed
        self._s_bkilled[slot] = budget_killed
        self._s_payload[slot] = self._p_payload[j]
        self._s_io[slot] = io_bytes
        t_fin = t0 + self.hw.cycles_ns(comp)
        if self.trace is not None:
            # rows emitted whole at completion (span_packet)
            self._s_uid[slot] = int(self._tr_uid_arr[j])
            self._s_grant[slot] = self.now
            self._s_tcomp[slot] = t_fin
        heapq.heappush(self._events,
                       (t_fin, self._seq,
                        K_SUBMIT if io_bytes else K_FIN, slot))
        self._seq += 1

    def _finish_slot(self, slot: int) -> None:
        idx = self._s_tenant[slot]
        wst = self.st
        co = wst.cur_occup
        co[idx] -= 1
        self.free_pus += 1
        o = int(co[idx])
        if o == 0 and wst.queue_len[idx] == 0:
            self._deactivate(idx)
        else:
            self._occF_act[idx] = o
            self._jain_upd(idx, o / self._prio_l[idx])
            if (not self._limit_dirty and not self._elig[idx]
                    and o < self._limit_l[idx] and wst.queue_len[idx] > 0):
                # the freed PU restored this tenant's eligibility
                self._elig[idx] = True
                self._elig_n += 1
                if self._elig_n == 1:
                    self._elig_one = idx
                else:
                    self._elig_one = -1
        now = self.now
        if self._s_killed[slot]:
            st = self.stats[idx]
            st.killed += 1
            self.tel.inc("killed", idx)
            self.eqhub.push_raw(
                idx, BudgetLedger.kill_kind(self._s_bkilled[slot]), now)
        else:
            payload = self._s_payload[slot]
            self._c_completed[idx] += 1
            self._c_served[idx] += payload
            tc = self._tc
            tc["completed"][idx] += 1.0
            tc["bytes_out"][idx] += payload
            d = self._tc_dirty
            d["completed"] = d["bytes_out"] = True
        self._kt_pend[idx].append(
            now - (self._s_t0[slot]
                   - self.hw.cycles_ns(self.hw.dma_setup_cycles)))
        self._c_lastcomp[idx] = now
        if self.record_completions:
            self._completions.append((idx, now))
        self._lat_append((idx, now - self._p_t[self._s_pkt[slot]]))
        self._c_fmqcomp[idx] += 1
        tr = self.trace
        if tr is not None:
            j = self._s_pkt[slot]
            tr.span_packet(self._s_uid[slot], idx, slot,
                           TR.D_KILL if self._s_killed[slot] else TR.D_OK,
                           self._tr_adisp[j], float(self._p_t[j]),
                           self._s_grant[slot], self._s_tcomp[slot], now)
        self._free_slots.append(slot)
        self._dispatch()

    # ------------------------------------------------------------------
    # IO path: same grant order as the event loop, typed records
    # ------------------------------------------------------------------
    def _submit_slot_transfer(self, slot: int) -> None:
        idx = self._s_tenant[slot]
        io_bytes = self._s_io[slot]
        kind = self._wl_io_kind[idx]
        frags = fragment_transfer(self.frag, idx, transfer_id=self._seq,
                                  nbytes=io_bytes)
        if self.frag.mode == "software":
            # kernel issues fragments one by one (blocking wrapper)
            rec = {"frags": frags, "i": 0, "idx": idx, "kind": kind,
                   "slot": slot}
            self._issue_sw(rec)
        else:
            for f in frags:
                self._enqueue_axi(idx, f, kind,
                                  ("fin", slot) if f.last else None)

    def _issue_sw(self, rec: dict) -> None:
        frags, i = rec["frags"], rec["i"]
        cb = ("sw", rec) if i + 1 < len(frags) else ("fin", rec["slot"])
        self._enqueue_axi(rec["idx"], frags[i], rec["kind"], cb)

    def _run_cb(self, cb) -> None:
        if cb is None:
            return
        if isinstance(cb, tuple):
            tag, arg = cb
            if tag == "fin":
                self._finish_slot(arg)
            else:                      # "sw": issue the next fragment
                arg["i"] += 1
                self._issue_sw(arg)
        else:
            cb(self.now)               # user callback (submit_control)

    def _kick_axi(self) -> None:
        if self.axi_busy:
            return
        ns_per_b = self.hw.wire_ns_per_byte(self.hw.axi_gbps)
        if self.axi_ctrl:
            nbytes, cb = self.axi_ctrl.popleft()
            self.axi_busy = True
            heapq.heappush(self._events,
                           (self.now + nbytes * ns_per_b, self._seq,
                            K_CTRL, cb))
            self._seq += 1
            return
        picked = self._axi_pick()
        if picked is None:
            return
        i, frag, kind, cb = picked
        overhead = (self.frag.hw_overhead_cycles
                    if self.frag.mode == "hardware" else 0)
        dur = frag.nbytes * ns_per_b + self.hw.cycles_ns(overhead)
        self.axi_busy = True
        heapq.heappush(self._events, (self.now + dur, self._seq, K_AXI,
                                      (i, frag, kind, cb)))
        self._seq += 1

    def _axi_done(self, payload) -> None:
        i, frag, kind, cb = payload
        self.axi_busy = False
        if kind == "egress":
            self._egress_enqueue(i, frag, cb)
        else:
            self._io_bytes_cum[i] += frag.nbytes
            self._win_io[i] += frag.nbytes
            self.stats[i].io_bytes_done += frag.nbytes
            self._run_cb(cb)
        self._kick_axi()

    def _kick_egress(self) -> None:
        if self.egress_busy:
            return
        picked = self._egress_pick()
        if picked is None:
            return
        i, frag, cb = picked
        dur = frag.nbytes * self.hw.wire_ns_per_byte(self.hw.egress_gbps)
        self.egress_busy = True
        heapq.heappush(self._events, (self.now + dur, self._seq, K_EGR,
                                      (i, frag, cb)))
        self._seq += 1

    def _egress_done(self, payload) -> None:
        i, frag, cb = payload
        self.egress_busy = False
        self._io_bytes_cum[i] += frag.nbytes
        self._win_io[i] += frag.nbytes
        self.stats[i].io_bytes_done += frag.nbytes
        self._run_cb(cb)
        self._kick_egress()

    def _ctrl_done(self, cb) -> None:
        self.axi_busy = False
        if cb:
            cb(self.now)
        self._kick_axi()

    # ------------------------------------------------------------------
    # arrivals
    # ------------------------------------------------------------------
    def _arrival_one(self, j: int) -> None:
        """One arrival, scalar — mirrors ``Simulator._arrival`` on the
        SoA store (used whenever a dispatch or an active-set change is
        possible; the caller has already advanced time to the packet)."""
        i = self._p_tenant_l[j]
        st = self.stats[i]
        if st.first_arrival == _INF:
            st.first_arrival = self.now
            self._fa_left -= 1
        tc = self._tc
        tc["arrivals"][i] += 1.0
        tc["bytes_in"][i] += self._p_size_l[j]
        d = self._tc_dirty
        d["arrivals"] = d["bytes_in"] = True
        fmq = self.fmqs[i]
        tr = self.trace
        if tr is not None:
            uid = self._tr_uid
            self._tr_uid += 1
            self._tr_uid_arr[j] = uid
        if not self._admit[i]:
            st.drops += 1
            self.tel.inc("rejected", i)
            self.eqhub.push_raw(i, EventKind.BACKPRESSURE, self.now)
            if tr is not None:
                tr.span(TR.ST_ARRIVE, uid, i, self.now, self.now,
                        TR.D_REJECT)
                TR.record_admission_reject(tr, self.now, i)
            return
        if self._fifo_len[i] >= self._fifo_cap[i]:
            st.drops += 1
            fmq.drops += 1
            self.tel.inc("drops", i)
            self.eqhub.push_raw(i, EventKind.QUEUE_OVERFLOW, self.now)
            if tr is not None:
                tr.span(TR.ST_ARRIVE, uid, i, self.now, self.now,
                        TR.D_DROP)
            return
        self._fifo[i].append(j)
        self._fifo_len[i] += 1
        fmq.enqueued += 1
        marked = self._fifo_len[i] >= self._ecn_thresh[i]
        if marked:
            fmq.ecn_marks += 1
            self.tel.inc("ecn_marks", i)
            self.eqhub.push_raw(i, EventKind.ECN_MARK, self.now)
            if tr is not None:
                # accepted packets get their ARRIVE row at completion
                # (span_packet); only the disposition is noted here
                self._tr_adisp[j] = TR.D_MARK
        if self.st.queue_len[i] == 0:
            self._limit_dirty = True
            if self.st.cur_occup[i] == 0:      # joins the active set
                self._act[i] = True
                self._act_n += 1
                self._act_f[i] = 1.0
                self._occF_act[i] = self.st.cur_occup[i]
                self._jain_cache = None
        self.st.queue_len[i] += 1
        self._dispatch()

    def _arrival_batch(self, t_ev: float, s_ev: int) -> None:
        """Apply every arrival up to the next decision point in one
        vectorized pass (valid only while ``free_pus == 0``: no arrival
        can dispatch).  The batch never crosses a telemetry-window
        boundary or a WLBVT active-set change, so the integration folds
        see exactly the intervals the event loop folds at."""
        ord_t, order = self._ord_t, self._order
        otl, osl = self._ord_t_l, self._ord_seq_l
        c, n = self._cursor, len(otl)
        b = self._win_start + self.io_window_ns
        bound = t_ev if t_ev < b else b
        hz = self._horizon
        if hz is not None and hz < bound:
            # horizon cut (inclusive: the event loop processes t ==
            # horizon and leaves strictly-later events queued)
            e = int(np.searchsorted(ord_t, hz, side="right"))
        else:
            e = int(np.searchsorted(ord_t, bound, side="left"))
            if t_ev < b:             # same-time heap event: seq decides
                while e < n and otl[e] == t_ev and osl[e] < s_ev:
                    e += 1
        if e > c + MAX_BATCH:        # bound the (m, T) fold buffers; the
            e = c + MAX_BATCH        # main loop re-enters for the rest
        if e > c and self._act_n < self._T:
            # never batch across a WLBVT active-set change: cut before
            # the first arrival that would activate an idle tenant
            inactive = (self.st.queue_len == 0) & (self.st.cur_occup == 0)
            mm = inactive[self._p_tenant[order[c:e]]]
            if mm.any():
                e = c + int(np.argmax(mm))
        if e <= c:
            # boundary-straddling or activating head: scalar path (the
            # shared _advance_to commits any window it crosses first)
            j = self._ord_j_l[c]
            self._cursor = c + 1
            t = otl[c]
            self._advance_to(t)
            self.now = t
            self._arrival_one(j)
            return
        m = e - c
        self._cursor = e
        if m < SMALL_BATCH or not self._admit_all:
            # tiny batch (or admission gating active): the scalar
            # per-arrival path — same ops as the event loop
            ojl = self._ord_j_l
            for k in range(c, e):
                t = otl[k]
                self._advance_small(t)
                self.now = t
                self._arrival_one(ojl[k])
            return
        batch = order[c:e]
        tn = self._p_tenant[batch]
        T = self._T
        st = self.st
        tr = self.trace
        if tr is not None:
            # uids in arrival-processing order, assigned for the whole
            # batch in one vectorized store
            tr_uids = self._tr_uid + np.arange(m, dtype=np.int64)
            self._tr_uid += m
            self._tr_uid_arr[batch] = tr_uids
        # --- integration folds (exact: cumsum == sequential adds) -----
        dts = np.empty(m)
        d0 = otl[c] - self._last_adv
        dts[0] = d0 if d0 > 0.0 else 0.0   # dt<=0: event loop skips it
        np.subtract(ord_t[c + 1:e], ord_t[c:e - 1], out=dts[1:])
        if self._fold_buf is None:
            self._fold_buf = np.empty((MAX_BATCH + 1, 2 * T))
        buf = self._fold_buf
        buf[0] = self._ob.reshape(-1)
        np.multiply(dts[:, None], self._advA.reshape(-1)[None, :],
                    out=buf[1:m + 1])
        # per-lane sequential accumulation == the event loop's += chain
        np.add.accumulate(buf[:m + 1], axis=0, out=buf[:m + 1])
        self._ob.reshape(-1)[:] = buf[m]
        if self._act_n >= 2:
            # the integrand is constant over the batch (occupancies do
            # not change): one fused add per accumulator — within the
            # documented bounded drift of the Jain fold (DESIGN.md §8)
            s = float(np.add.reduce(dts))
            self._jain_pu_acc += self._jain_cur() * s
            self._jain_pu_t += s
        last_t = otl[e - 1]
        self._last_adv = last_t
        self.now = last_t
        # --- counters + first arrivals --------------------------------
        counts = np.bincount(tn, minlength=T)
        self._st_arrivals += counts
        self._st_bytes_in += np.bincount(
            tn, weights=self._p_size[batch], minlength=T)
        if self._fa_left:
            for i in np.flatnonzero(counts).tolist():
                s = self.stats[i]
                if s.first_arrival == _INF:
                    s.first_arrival = otl[c + int(np.argmax(tn == i))]
                    self._fa_left -= 1
        # --- FMQ depth classification ---------------------------------
        # 0 = accepted, 1 = accepted + ECN-marked, 2 = dropped.  Depth
        # only grows inside a batch (no pops: every PU is busy), so a
        # tenant is either all-drop (already full), all-fit (stays below
        # the ECN threshold), or walked scalar through the transition.
        fl = self._fifo_len
        full_t = fl >= self._fifo_cap
        if bool(full_t.all()):
            # flood steady state: every FMQ is full, every arrival drops
            # — no FIFO/queue/scheduler state changes, so the batch
            # reduces to drop counters + the EQ block
            self._acc_drops += counts
            self._acc_fmq_drops += counts
            self._st_drops += counts
            self.eqhub.push_block(tn, self._kind2[:m], ord_t[c:e])
            if tr is not None:
                tr.span_block(TR.ST_ARRIVE, tr_uids, tn, ord_t[c:e],
                              ord_t[c:e], TR.D_DROP)
            return
        open_pos = (~full_t[tn]).nonzero()[0]
        if open_pos.size <= 16:
            # near-full flood — the steady state right after PU pops
            # left a few FMQs a slot below capacity: only the open
            # tenants' few packets walk the scalar accept/mark/drop
            # ladder (identical transitions to FMQ.push), everything
            # else drops in block, chronological order preserved
            kind = np.full(m, 2, np.int8)
            ojl = self._ord_j_l
            ql = st.queue_len
            tn_open = self._p_tenant_l
            open_state: dict = {}
            cap_l, thr_l = self._fifo_cap_l, self._ecn_thresh_l
            n_acc = 0
            any_mark = False
            for k in open_pos.tolist():
                q = ojl[c + k]
                i = tn_open[q]
                s = open_state.get(i)
                if s is None:
                    s = open_state[i] = [int(fl[i]), cap_l[i], thr_l[i], 0]
                if s[0] < s[1]:
                    s[0] = d = s[0] + 1
                    s[3] += 1
                    n_acc += 1
                    self._fifo[i].append(q)
                    if d >= s[2]:          # accepted but ECN-marked
                        kind[k] = 1
                        any_mark = True
                    else:
                        kind[k] = 0
            nd = counts.copy()
            for i, s in open_state.items():
                a = s[3]
                if a:
                    nd[i] -= a
                    if ql[i] == 0:         # non-empty set grew
                        self._limit_dirty = True
                    ql[i] += a
                    fl[i] = s[0]
                    self._acc_enq[i] += a
            if any_mark:
                for k in (kind == 1).nonzero()[0].tolist():
                    i = tn_open[ojl[c + k]]
                    self._acc_marks[i] += 1
                    self.tel.inc("ecn_marks", i, 1)
            self._acc_drops += nd
            self._acc_fmq_drops += nd
            self._st_drops += nd
            if n_acc == 0:
                self.eqhub.push_block(tn, kind, ord_t[c:e])
            else:
                ev_pos = kind.nonzero()[0]
                if ev_pos.size:
                    self.eqhub.push_block(tn[ev_pos], kind[ev_pos],
                                          ord_t[c:e][ev_pos])
            if tr is not None:
                dsel = (kind == 2).nonzero()[0]
                if dsel.size:
                    tr.span_block(TR.ST_ARRIVE, tr_uids[dsel], tn[dsel],
                                  ord_t[c:e][dsel], ord_t[c:e][dsel],
                                  TR.D_DROP)
                msel = (kind == 1).nonzero()[0]
                if msel.size:
                    self._tr_adisp[batch[msel]] = TR.D_MARK
            return
        fit_t = fl + counts < self._ecn_thresh
        kind = None
        if full_t.any() or not fit_t.all():
            lut = self._kind_lut
            np.multiply(full_t, 2, out=lut, casting="unsafe")
            kind = lut[tn]
            trans_t = ~(full_t | fit_t) & (counts > 0)
            if trans_t.any():
                for i in np.flatnonzero(trans_t).tolist():
                    d = int(fl[i])
                    C = int(self._fifo_cap[i])
                    E = int(self._ecn_thresh[i])
                    for k in np.flatnonzero(tn == i).tolist():
                        if d >= C:
                            kind[k] = 2
                        else:
                            d += 1
                            if d >= E:
                                kind[k] = 1
        # --- accepted: FIFO pushes + queue/depth counters -------------
        if kind is None:
            acc_counts = counts
            atn, pkt = tn, batch
        else:
            acc_sel = np.flatnonzero(kind != 2)
            acc_counts = np.bincount(tn[acc_sel], minlength=T)
            atn, pkt = tn[acc_sel], batch[acc_sel]
        if atn.size:
            if not self._limit_dirty and np.any(
                    (st.queue_len == 0) & (acc_counts > 0)):
                self._limit_dirty = True
            fl += acc_counts
            st.queue_len += acc_counts
            self._acc_enq += acc_counts
            o = np.argsort(atn, kind="stable")   # per-tenant time order
            fifo = self._fifo
            for i, q in zip(atn[o].tolist(), pkt[o].tolist()):
                fifo[i].append(q)
        # --- flagged packets: stats, telemetry, EQ events -------------
        if kind is not None:
            flagged = np.flatnonzero(kind)
            if flagged.size:
                ftn = tn[flagged]
                fk = kind[flagged]
                drop_t = ftn[fk == 2]
                mark_t = ftn[fk == 1]
                if drop_t.size:
                    nd = np.bincount(drop_t, minlength=T)
                    self._acc_drops += nd
                    self._acc_fmq_drops += nd
                    self.tel.inc_column("drops", nd)
                if mark_t.size:
                    nm = np.bincount(mark_t, minlength=T)
                    self._acc_marks += nm
                    self.tel.inc_column("ecn_marks", nm)
                # EQ events stay per packet in chronological order; the
                # block log materializes only the retained ring window
                self.eqhub.push_block(ftn, fk, ord_t[c:e][flagged])
        if tr is not None and kind is not None:
            dsel = (kind == 2).nonzero()[0]
            if dsel.size:
                tr.span_block(TR.ST_ARRIVE, tr_uids[dsel], tn[dsel],
                              ord_t[c:e][dsel], ord_t[c:e][dsel],
                              TR.D_DROP)
            msel = (kind == 1).nonzero()[0]
            if msel.size:
                self._tr_adisp[batch[msel]] = TR.D_MARK

    def _flush_accumulators(self) -> None:
        """Fold the batch-side vector counters and the scalar-hot-path
        list accumulators into the per-tenant stat/FMQ/ledger objects
        (same final values as per-event increments)."""
        self._flush_tc()
        for i in np.flatnonzero(self._acc_drops
                                | self._acc_marks | self._acc_enq).tolist():
            self.stats[i].drops += int(self._acc_drops[i])
            fmq = self.fmqs[i]
            fmq.drops += int(self._acc_fmq_drops[i])
            fmq.ecn_marks += int(self._acc_marks[i])
            fmq.enqueued += int(self._acc_enq[i])
        self._acc_drops[:] = 0
        self._acc_fmq_drops[:] = 0
        self._acc_marks[:] = 0
        self._acc_enq[:] = 0
        for i in range(self._T):
            st = self.stats[i]
            c = self._c_completed[i]
            if c:
                st.completed += c
                st.served_payload_bytes += self._c_served[i]
                self._c_completed[i] = 0
                self._c_served[i] = 0.0
            if self._c_lastcomp[i] > st.last_completion:
                st.last_completion = self._c_lastcomp[i]
            fc = self._c_fmqcomp[i]
            if fc:
                self.fmqs[i].completed += fc
                self._c_fmqcomp[i] = 0
            kts = self._kt_pend[i]
            if kts:
                n, mv = st.kernel_time_count, len(kts)
                if n + mv <= KT_RESERVOIR_CAP:
                    if st._kt_buf is None:
                        st._kt_buf = np.empty(KT_RESERVOIR_CAP)
                    st._kt_buf[n:n + mv] = kts     # one vectorized fill
                    st.kernel_time_count = n + mv
                    s = st.kernel_time_sum
                    for v in kts:                  # same sequential adds
                        s += v
                    st.kernel_time_sum = s
                    st._kt_pcache = None
                else:                              # straddles the cap:
                    for v in kts:                  # exact replay
                        st.record_kernel_time(v)
                self._kt_pend[i] = []
        self.budget.spent[:] = self._spent

    # ------------------------------------------------------------------
    # trace plane
    # ------------------------------------------------------------------
    def trace_flush(self, t: float) -> None:
        """End-of-run flush mirroring the event loop's override row for
        row: queued packets from the SoA FIFOs, in-flight ones from the
        slot table, in uid order."""
        tr = self.trace
        if tr is None:
            return
        ents = []
        for i, q in enumerate(self._fifo):
            for j in q:
                ents.append((int(self._tr_uid_arr[j]), i,
                             float(self._p_t[j]),
                             int(self._tr_adisp[j]), None))
        busy = set(range(self.hw.num_pus)) - set(self._free_slots)
        for slot in busy:
            j = self._s_pkt[slot]
            ents.append((self._s_uid[slot], self._s_tenant[slot],
                         float(self._p_t[j]), int(self._tr_adisp[j]),
                         (slot, self._s_grant[slot],
                          self._s_tcomp[slot])))
        for uid, ten, arr, adisp, m in sorted(ents, key=lambda e: e[0]):
            tr.span(TR.ST_ARRIVE, uid, ten, arr, arr, adisp)
            if m is None:
                tr.span(TR.ST_FMQ, uid, ten, arr, t, TR.D_OPEN)
                continue
            slot, g, tc = m
            tr.span(TR.ST_FMQ, uid, ten, arr, g, TR.D_OK, pu=slot)
            tr.span(TR.ST_GRANT, uid, ten, g, g, TR.D_OK, pu=slot)
            if t >= tc:
                tr.span(TR.ST_PU, uid, ten, g, tc, TR.D_OK, pu=slot)
                tr.span(TR.ST_DMA, uid, ten, tc, t, TR.D_OPEN, pu=slot)
            else:
                tr.span(TR.ST_PU, uid, ten, g, t, TR.D_OPEN, pu=slot)
        tr.commit()

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self, trace, horizon: Optional[float] = None) -> SimResult:
        self._inject(trace)
        self._admit_all = bool(self._admit.all())
        self._horizon = horizon      # arrival batches must not cross it
        ev = self._events
        inf = _INF
        while True:
            c = self._cursor
            otl = self._ord_t_l
            have_arr = c < len(otl)
            t_arr = otl[c] if have_arr else inf
            if ev:
                t_ev, s_ev = ev[0][0], ev[0][1]
            else:
                t_ev, s_ev = inf, -1
            if not have_arr and not ev:
                break
            arr_first = (t_arr < t_ev
                         or (t_arr == t_ev and self._ord_seq_l[c] < s_ev))
            t_next = t_arr if arr_first else t_ev
            if horizon is not None and t_next > horizon:
                break            # leave the work queued for a later run()
            if arr_first:
                if self.free_pus == 0:
                    self._arrival_batch(t_ev, s_ev)
                else:
                    j = self._ord_j_l[c]
                    self._cursor = c + 1
                    self._advance(t_arr)
                    self.now = t_arr
                    self._arrival_one(j)
            else:
                t, _, code, payload = heapq.heappop(ev)
                self._advance(t)
                self.now = t
                if code == K_FIN:
                    self._finish_slot(payload)
                elif code == K_SUBMIT:
                    self._submit_slot_transfer(payload)
                elif code == K_AXI:
                    self._axi_done(payload)
                elif code == K_EGR:
                    self._egress_done(payload)
                else:
                    self._ctrl_done(payload)
        self._flush_accumulators()
        tl = None
        if self.record_timeline:
            tl = {k: np.array(v) for k, v in self._tl.items()}
        self.tel.commit()        # flush any partial-window staged samples
        if self.trace is not None:
            self.trace.commit()
        return SimResult(
            time=self.now,
            stats=self.stats,
            jain_pu_timeavg=(self._jain_pu_acc / self._jain_pu_t
                             if self._jain_pu_t else 1.0),
            jain_io_timeavg=(self._jain_io_acc / self._jain_io_t
                             if self._jain_io_t else 1.0),
            timeline=tl,
            events=self.eqhub.drain_all(),
            telemetry=self.tel,
            sched_state={
                "prio": self.st.prio.copy(),
                "total_occup": self.st.total_occup.copy(),
                "bvt": self.st.bvt.copy(),
                "kv_pressure": self._kv_pressure_row(),
            },
            completions=(list(self._completions)
                         if self.record_completions else None),
        )


DATAPATHS = {"event": Simulator, "batched": BatchedSimulator}


def build_simulator(tenants, *, datapath: str = "event", **kw) -> Simulator:
    """Factory over the two simulator data planes (same semantics)."""
    try:
        cls = DATAPATHS[datapath]
    except KeyError:
        raise ValueError(f"unknown datapath {datapath!r} "
                         f"(want one of {sorted(DATAPATHS)})") from None
    return cls(tenants, **kw)
