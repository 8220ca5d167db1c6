"""Discrete-event, cycle-level simulator of the OSMOSIS/PsPIN datapath.

Models (paper §6-§7 setup): 4 clusters × 8 PUs @ 1 GHz, 400 Gbit/s
ingress/egress, 512 Gbit/s shared AXI for DMA + egress-buffer writes,
per-FMQ FIFOs, WLBVT (or RR) PU scheduling, DWRR IO arbitration with
off/software/hardware transfer fragmentation, per-kernel watchdog budgets,
and an EQ control path served at highest IO priority.

Event timing is exact: WLBVT's per-cycle ``update_tput`` is integrated
lazily over piecewise-constant occupancy intervals (numerically identical
to the per-cycle update).

``Simulator`` is the event-loop path: one Python callback per event,
auditable against the paper's mechanism descriptions.  The
tenant/budget/EQ/telemetry plumbing lives in ``core/engine_base.py``
(shared with the serving engine), and the array-batched datapath in
``sim/fastpath.py`` reproduces this engine's decisions bit for bit at a
multiple of the packet rate.  The sweep datapath (``sim/devicepath.py``)
rebuilds its results into ``TenantStats``, so a replica's statistics
carry the same fields, the same kernel-time reservoir and the same
``default_rng(0xA11CE)`` replacement stream as these simulators:
percentiles are bit-identical.  All of it is numpy on the host, as in the
JAX package, whose ``RunReport`` JSON the port reproduces byte for byte.
With ``trace=True`` the flight recorder (``telemetry/trace.py``) records
packet lifecycles and scheduler provenance under every
``if self.trace is not None`` hook; with it off the hooks cost one
attribute check.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.osmosis_pspin import PSPIN, PsPINConfig
from repro_torch.core import (ECTX, EngineBase, EventKind, Event, FMQ,
                              FragmentationPolicy, MatchingEngine,
                              PacketDescriptor, PushResult,
                              fragment_transfer)
from repro_torch.core.accounting import jain_fairness
from repro_torch.core.engine_base import BudgetLedger
from repro_torch.core import wlbvt as W
from repro_torch.sim.traffic import TracePacket
from repro_torch.sim.workloads import WorkloadModel
from repro_torch.telemetry import G_IDX, GAUGES, Telemetry
from repro_torch.telemetry import trace as TR

KT_RESERVOIR_CAP = 4096   # kernel-time samples retained per tenant
_KT_RNG_SEED = 0xA11CE    # reservoir replacement stream (deterministic)

# module-local copies of the hot trace dispositions: one global load in
# the per-completion path instead of a module-attribute lookup
_D_OK, _D_MARK, _D_KILL = TR.D_OK, TR.D_MARK, TR.D_KILL


@dataclasses.dataclass
class TenantStats:
    completed: int = 0
    killed: int = 0
    drops: int = 0
    served_payload_bytes: float = 0.0
    io_bytes_done: float = 0.0
    first_arrival: float = float("inf")
    last_completion: float = 0.0
    # kernel service times: bounded reservoir (Algorithm R once past the
    # cap) + exact running count/sum — percentiles derive from the
    # reservoir instead of an unbounded list (below the cap the sample
    # is complete, so they are exact)
    kernel_time_count: int = 0
    kernel_time_sum: float = 0.0
    _kt_buf: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    _kt_rng: Optional[np.random.Generator] = dataclasses.field(
        default=None, repr=False, compare=False)
    _kt_pcache: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)

    def record_kernel_time(self, value: float) -> None:
        n = self.kernel_time_count
        if self._kt_buf is None:
            self._kt_buf = np.empty(KT_RESERVOIR_CAP)
        if n < KT_RESERVOIR_CAP:
            self._kt_buf[n] = value
        else:
            if self._kt_rng is None:
                self._kt_rng = np.random.default_rng(_KT_RNG_SEED)
            j = int(self._kt_rng.integers(0, n + 1))
            if j < KT_RESERVOIR_CAP:
                self._kt_buf[j] = value
        self.kernel_time_count = n + 1
        self.kernel_time_sum += value
        self._kt_pcache = None

    def record_kernel_times(self, values: np.ndarray) -> None:
        """Bulk replay of ``record_kernel_time`` over ``values`` in
        order, bit-identical to the sequential calls: the fill phase is
        a copy, the sum a ``cumsum`` tail (left-to-right accumulation,
        same rounding as ``+=``), and only samples past the reservoir
        cap walk the replacement rng one draw at a time."""
        values = np.asarray(values, dtype=float)
        if values.size == 0:
            return
        if self.kernel_time_count or self._kt_buf is not None:
            for v in values:              # mid-stream: no shortcut
                self.record_kernel_time(float(v))
            return
        buf = np.empty(KT_RESERVOIR_CAP)
        m = min(values.size, KT_RESERVOIR_CAP)
        buf[:m] = values[:m]
        self._kt_buf = buf
        if values.size > KT_RESERVOIR_CAP:
            rng = np.random.default_rng(_KT_RNG_SEED)
            for k in range(KT_RESERVOIR_CAP, values.size):
                j = int(rng.integers(0, k + 1))
                if j < KT_RESERVOIR_CAP:
                    buf[j] = values[k]
            self._kt_rng = rng
        self.kernel_time_count = int(values.size)
        self.kernel_time_sum = float(values.cumsum()[-1])
        self._kt_pcache = None

    @property
    def kernel_times(self) -> np.ndarray:
        """The retained kernel-time sample (complete below the cap).
        ``kernel_time_count``/``kernel_time_sum`` are always exact."""
        if self._kt_buf is None:
            return np.empty(0)
        return self._kt_buf[:min(self.kernel_time_count, KT_RESERVOIR_CAP)]

    def kernel_time_percentile(self, q: float) -> float:
        """Reservoir percentile, cached until the next sample lands."""
        if self.kernel_time_count == 0:
            return 0.0
        if self._kt_pcache is None:
            self._kt_pcache = {}
        if q not in self._kt_pcache:
            self._kt_pcache[q] = float(np.percentile(self.kernel_times, q))
        return self._kt_pcache[q]

    @property
    def fct(self) -> float:
        """Flow completion time: ``last_completion - first_arrival``.

        Explicitly 0.0 when the tenant saw no arrivals (packets injected
        before registration leave ``first_arrival`` unset) or no
        completions — previously the ``min(first_arrival,
        last_completion)`` guard silently collapsed those to 0."""
        if self.last_completion <= 0 or self.first_arrival == float("inf"):
            return 0.0
        return max(0.0, self.last_completion - self.first_arrival)


@dataclasses.dataclass
class SimResult:
    """Backend-native result bundle.

    Deprecated as a public surface: external consumers should run
    through ``repro_torch.api`` (``SimRuntime``/``run_scenario``) and consume
    the portable, backend-neutral ``RunReport`` instead (DESIGN.md §7).
    """
    time: float
    stats: Dict[int, TenantStats]
    jain_pu_timeavg: float
    jain_io_timeavg: float
    timeline: Optional[dict] = None
    events: List[Event] = dataclasses.field(default_factory=list)
    telemetry: Optional[Telemetry] = None
    sched_state: Optional[dict] = None   # final prio/total_occup/bvt +
    #                                      FIFO pressure, for signal reads
    completions: Optional[list] = None   # (tenant, t) per kernel finish,
    #                                      when record_completions is set

    def throughput_gbps(self, tenant: int) -> float:
        st = self.stats[tenant]
        return st.served_payload_bytes * 8.0 / max(self.time, 1e-9)

    def p50(self, tenant: int) -> float:
        return self.stats[tenant].kernel_time_percentile(50)

    def p99(self, tenant: int) -> float:
        return self.stats[tenant].kernel_time_percentile(99)


class Simulator(EngineBase):
    def __init__(self, tenants: List[ECTX], *,
                 scheduler: str = "wlbvt",
                 frag: Optional[FragmentationPolicy] = None,
                 arb: str = "dwrr",
                 hw: PsPINConfig = PSPIN,
                 fifo_capacity: int = 4096,
                 io_demand_weights=None,
                 record_timeline: bool = False,
                 controller=None,
                 control_interval_ns: float = 8000.0,
                 record_completions: bool = False,
                 trace: bool = False,
                 trace_depth: int = 65536,
                 trace_decision_depth: int = 8192):
        T = len(tenants)
        super().__init__(T, shared_eq=True, trace=trace,
                         trace_depth=trace_depth,
                         trace_decision_depth=trace_decision_depth,
                         trace_pus=hw.num_pus)
        self.hw = hw
        self.sched_kind = scheduler
        self.frag = frag or FragmentationPolicy(mode="off")
        self.record_timeline = record_timeline
        self.record_completions = record_completions

        self.fmqs: List[FMQ] = []
        self.matching = MatchingEngine()
        for i, e in enumerate(tenants):
            self.register_tenant(e, fmq_index=i)
            self.fmqs.append(FMQ(index=i, ectx=e, capacity=fifo_capacity))
        prios = [e.slo.priority for e in tenants]
        self.st = W.WLBVTState.create(prios)
        self.rr_ptr = 0

        self.free_pus = hw.num_pus

        # AXI: per-tenant fragment queues; entries are
        # (Fragment, kind, done_cb|None).  arb: "dwrr" (OSMOSIS) or "fifo"
        # (reference PsPIN — a blocking interconnect with no QoS: grants in
        # strict arrival order => HoL blocking, paper Fig. 5).
        self.arb = arb
        self.axi_q: List[deque] = [deque() for _ in range(T)]
        self.axi_fifo: deque = deque()     # arrival order (fifo mode)
        self.axi_ctrl: deque = deque()     # EQ/control traffic, R5 priority
        self.axi_busy = False
        self.dwrr = W.DWRRState.create(
            [e.slo.dma_priority for e in tenants])
        # egress link: same arbitration discipline as the DMA engine
        self.egress_q: List[deque] = [deque() for _ in range(T)]
        self.egress_fifo: deque = deque()
        self.egress_busy = False
        self.egress_dwrr = W.DWRRState.create(
            [e.slo.egress_priority for e in tenants])

        self._events: list = []
        self._seq = 0
        self.now = 0.0
        self._last_adv = 0.0
        self.stats: Dict[int, TenantStats] = {i: TenantStats()
                                              for i in range(T)}
        self._completions: list = []
        # fairness integrals; IO fairness uses windowed byte counts so the
        # metric reflects per-window shares, not event granularity
        self._jain_pu_acc = 0.0
        self._jain_pu_t = 0.0
        self._jain_io_acc = 0.0
        self._jain_io_t = 0.0
        self.io_window_ns = 2000.0
        self.io_demand_weights = (np.ones(T) if io_demand_weights is None
                                  else np.asarray(io_demand_weights, float))
        self._win_start = 0.0
        self._win_io = np.zeros(T)
        self._win_act = np.zeros(T, bool)
        self._io_bytes_cum = np.zeros(T)
        self._tl: Dict[str, list] = {"t": [], "occup": [], "io_win": [],
                                     "qlen": []}
        # telemetry plane (EngineBase; always on, committed at window
        # boundaries) + optional closed-loop QoS controller
        self.controller = controller
        # SLO-configured base weights per knob: the controller scales
        # these (live = base * boost), never overwrites them
        self._sched_base = (self.st.prio.copy(), self.dwrr.weights.copy(),
                            self.egress_dwrr.weights.copy())
        self._ctrl_every = max(1, int(round(control_interval_ns
                                            / self.io_window_ns)))
        self._win_count = 0
        self._gauges_buf = np.zeros((len(GAUGES), T))
        # trace plane (EngineBase seam; None unless trace=True): uids are
        # assigned in arrival-processing order, and a tracing-only free-slot
        # mirror attributes PU_EXEC spans to slots exactly like the batched
        # datapath's slot table (list(range(P-1,-1,-1)), pop from the end)
        self._tr_uid = 0
        self._tr_free = (list(range(hw.num_pus - 1, -1, -1))
                         if self.trace is not None else None)
        # tracing-only slot columns (uid / grant / t_comp / packet), so
        # the hot paths never allocate per-packet records: pkt.meta is
        # the uid while queued, then the slot index once granted.  A
        # finished slot's packet ref goes stale rather than being
        # cleared — trace_flush walks only busy (non-free) slots
        P = hw.num_pus
        self._tr_s_uid = [0] * P
        self._tr_s_grant = [0.0] * P
        self._tr_s_tcomp = [0.0] * P
        self._tr_s_pkt: List[Optional[PacketDescriptor]] = [None] * P

    # -- event machinery ---------------------------------------------------
    def _post(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._events, (t, self._seq, fn))
        self._seq += 1

    def _advance_to(self, t: float) -> None:
        dt = t - self._last_adv
        if dt <= 0:
            return
        # WLBVT bookkeeping (lazy per-cycle integration)
        W.advance(self.st, dt)
        # fairness integrals over the interval
        occ = self.st.cur_occup.astype(float)
        act = self.st.active
        if act.sum() >= 2:
            prio = self.st.prio
            self._jain_pu_acc += jain_fairness((occ / prio)[act]) * dt
            self._jain_pu_t += dt
        self._win_act |= act
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
            self._win_act = self.st.active.copy()
            self._win_start += self.io_window_ns
        self._last_adv = t

    def _kv_pressure_row(self) -> np.ndarray:
        """Per-tenant FIFO pressure (depth / capacity) — the sim analogue
        of the serving engine's KV pressure gauge.  The batched fast path
        overrides this with its SoA depth counters (same values)."""
        return np.array([len(f) / f.capacity for f in self.fmqs])

    def drain_tenant_queue(self, tenant: int) -> List[Tuple[float, int]]:
        """Live-migration drain (DESIGN.md §12.3): pull every queued —
        not yet scheduled — packet out of one tenant's FMQ, returning
        ``(arrival_ns, size_bytes)`` rows in FIFO order for the fleet
        engine to replay on the destination NIC.  Work already
        executing on a PU finishes in place here; only queue state
        migrates.  Call between ``run`` slices, never mid-run."""
        fmq = self.fmqs[tenant]
        out = [(pd.arrival, pd.size_bytes) for pd in fmq.fifo]
        fmq.fifo.clear()
        if out:
            self.st.queue_len[tenant] -= len(out)
        return out

    def _commit_window(self, occ: np.ndarray) -> None:
        """Flush staged telemetry + push gauge samples for one IO window;
        publish the observability frame, then run the QoS control loop
        every ``_ctrl_every`` windows (observe-before-control, so a
        boundary-coincident SLO alert precedes the intervention)."""
        self.tel.commit()
        if self.trace is not None:
            self.trace.maybe_commit()   # batched ring scatter (size-gated)
        gauges = self._gauges_buf    # all rows overwritten below
        gauges[G_IDX["occupancy"]] = occ
        gauges[G_IDX["queue_len"]] = self.st.queue_len
        gauges[G_IDX["service_rate"]] = self._win_io / self.io_window_ns
        gauges[G_IDX["kv_pressure"]] = self._kv_pressure_row()
        self.tel.commit_window(gauges)
        self._win_count += 1
        win_end_ns = self._win_start + self.io_window_ns
        self.observe_tick(
            t=win_end_ns, prio=self.st.prio,
            total_occup=self.st.total_occup, bvt=self.st.bvt,
            kv_pressure=gauges[G_IDX["kv_pressure"]])
        if (self.controller is not None
                and self._win_count % self._ctrl_every == 0):
            pb, db, eb = self._sched_base
            self.qos_tick(
                prio=self.st.prio, total_occup=self.st.total_occup,
                bvt=self.st.bvt,
                kv_pressure=gauges[G_IDX["kv_pressure"]],
                knobs=((self.st.prio, pb), (self.dwrr.weights, db),
                       (self.egress_dwrr.weights, eb)),
                t=win_end_ns)

    # -- ingress -------------------------------------------------------------
    def _arrival(self, pkt: TracePacket) -> None:
        i = pkt.tenant  # tenant id == fmq index (matching by construction)
        fmq = self.fmqs[i]
        st = self.stats[i]
        st.first_arrival = min(st.first_arrival, self.now)
        self.tel.inc("arrivals", i)
        self.tel.inc("bytes_in", i, pkt.size)
        tr = self.trace
        if tr is not None:
            uid = self._tr_uid
            self._tr_uid += 1
        if not self._admit[i]:
            # controller backpressure: source-throttled before the FMQ.
            # Telemetry counts this as "rejected", NOT "drops" — drop_rate
            # feeds the controller's pressure signal, and counting gated
            # arrivals there would latch a paused tenant paused forever.
            st.drops += 1
            self.tel.inc("rejected", i)
            self.eqhub.push(Event(i, EventKind.BACKPRESSURE, self.now))
            if tr is not None:
                tr.span(TR.ST_ARRIVE, uid, i, self.now, self.now,
                        TR.D_REJECT)
                TR.record_admission_reject(tr, self.now, i)
            return
        pd = PacketDescriptor(i, pkt.size, self.now)
        res = fmq.push(pd)
        if res == PushResult.DROPPED:
            st.drops += 1
            self.tel.inc("drops", i)
            self.eqhub.push(Event(i, EventKind.QUEUE_OVERFLOW, self.now))
            if tr is not None:
                tr.span(TR.ST_ARRIVE, uid, i, self.now, self.now,
                        TR.D_DROP)
            return
        if res == PushResult.MARKED:
            # paper's mark-before-drop path: congestion signal surfaced
            # through the tenant EQ and the telemetry plane before losses
            self.tel.inc("ecn_marks", i)
            self.eqhub.push(Event(i, EventKind.ECN_MARK, self.now))
        if tr is not None:
            # all rows (ARRIVE included) are staged whole at
            # completion; the arrive disposition rides on pkt.ecn
            pd.meta = uid
        self.st.queue_len[i] += 1
        self._dispatch()

    # -- PU scheduling ---------------------------------------------------------
    def _pop_and_start(self, idx: int) -> None:
        pkt = self.fmqs[idx].pop()
        assert pkt is not None
        self.free_pus -= 1
        if self.trace is not None:
            slot = self._tr_free.pop()
            self._tr_s_uid[slot] = pkt.meta
            self._tr_s_grant[slot] = self.now
            pkt.meta = slot
            self._tr_s_pkt[slot] = pkt  # rows emitted whole at completion
        self._start_kernel(idx, pkt)

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
                self._pop_and_start(idx)
            return
        if self.free_pus <= 0:
            return
        # one batched WLBVT round fills every free PU (select_k charges
        # queue_len/cur_occup per pick, matching the scalar loop)
        if tr is None:
            for idx in W.select_k(self.st, self.hw.num_pus, self.free_pus):
                if idx < 0:
                    break
                self._pop_and_start(int(idx))
            return
        # provenance: stage the picks + the post-round state; the
        # pre-round arrays are reconstructed at commit (the picks are
        # exactly the charge select_k applied).  The common round frees
        # exactly one PU, so the single-pick case skips the list
        npus = self.hw.num_pus
        first = -1
        picks = None
        for idx in W.select_k(self.st, npus, self.free_pus):
            if idx < 0:
                break
            i = int(idx)
            if first < 0:
                first = i
            elif picks is None:
                picks = [first, i]
            else:
                picks.append(i)
            self._pop_and_start(i)
        if first >= 0:
            TR.record_wlbvt_round(
                tr, self.now, self.st,
                picks if picks is not None else (first,),
                npus, TR.K_PU_WLBVT)

    def _start_kernel(self, idx: int, pkt: PacketDescriptor) -> None:
        fmq = self.fmqs[idx]
        wl: WorkloadModel = fmq.ectx.kernel
        payload = max(0, pkt.size_bytes - self.hw.header_bytes)
        # L2->L1 DMA, hides sched
        t0 = self.now + self.hw.cycles_ns(self.hw.dma_setup_cycles)
        comp = wl.compute_cycles(payload)
        # watchdog budgets (shared clamp semantics: core/engine_base.py) —
        # the per-kernel cycle limit, then the tenant's remaining lifetime
        # allowance (billing, §5.2; exhaustion is permanent)
        comp, killed = BudgetLedger.clamp_kernel(
            comp, fmq.ectx.slo.kernel_cycle_limit)
        comp, budget_killed = self.budget.clamp_total(
            idx, comp, fmq.ectx.slo.total_cycle_limit)
        killed = killed or budget_killed
        io_bytes = 0 if killed else wl.io_bytes(payload)

        if io_bytes and self.frag.mode == "software":
            nfrag = -(-io_bytes // self.frag.fragment_bytes)
            comp += self.frag.sw_overhead_cycles * nfrag

        t_comp = t0 + self.hw.cycles_ns(comp)
        if self.trace is not None:
            self._tr_s_tcomp[pkt.meta] = t_comp

        def fin(t_done: float, was_killed=killed, was_budget=budget_killed):
            self._finish_kernel(idx, pkt, t0, t_done, was_killed, payload,
                                budget_killed=was_budget)

        if io_bytes:
            self._post(t_comp, lambda: self._submit_transfer(
                idx, io_bytes, wl.io_kind,
                lambda t_done: fin(t_done)))
        else:
            self._post(t_comp, lambda: fin(self.now))

    def _finish_kernel(self, idx, pkt, t_start, t_done, killed, payload,
                       budget_killed=False):
        st = self.stats[idx]
        self.st.cur_occup[idx] -= 1
        self.free_pus += 1
        if killed:
            st.killed += 1
            self.tel.inc("killed", idx)
            self.eqhub.push(Event(idx, BudgetLedger.kill_kind(budget_killed),
                                  self.now))
        else:
            st.completed += 1
            st.served_payload_bytes += payload
            self.tel.inc("completed", idx)
            self.tel.inc("bytes_out", idx, payload)
        st.record_kernel_time(
            self.now - (t_start - self.hw.cycles_ns(self.hw.dma_setup_cycles)))
        st.last_completion = self.now
        if self.record_completions:
            self._completions.append((idx, self.now))
        # sojourn (arrival -> completion) latency: queueing included, so
        # the control plane sees congestion the service time alone hides
        self.tel.lat(idx, self.now - pkt.arrival)
        tr = self.trace
        if tr is not None:
            slot = pkt.meta
            tr.span_packet(self._tr_s_uid[slot], idx, slot,
                           _D_KILL if killed else _D_OK,
                           _D_MARK if pkt.ecn else _D_OK,
                           pkt.arrival, self._tr_s_grant[slot],
                           self._tr_s_tcomp[slot], self.now)
            self._tr_free.append(slot)
        self.fmqs[idx].completed += 1
        self._dispatch()

    # -- AXI / DMA / egress ------------------------------------------------------
    def _submit_transfer(self, idx: int, nbytes: int, kind: str,
                         cb: Callable[[float], None]) -> None:
        frags = fragment_transfer(self.frag, idx, transfer_id=self._seq,
                                  nbytes=nbytes)
        if self.frag.mode == "software":
            # kernel issues fragments one by one (blocking wrapper)
            def issue(i: int):
                f = frags[i]
                if i + 1 < len(frags):
                    nxt = lambda _t: issue(i + 1)
                else:
                    nxt = cb
                self._enqueue_axi(idx, f, kind, nxt)
            issue(0)
        else:
            for f in frags:
                self._enqueue_axi(idx, f, kind, cb if f.last else None)

    def _enqueue_axi(self, idx, frag, kind, cb) -> None:
        if self.arb == "fifo":
            self.axi_fifo.append((idx, frag, kind, cb))
        else:
            self.axi_q[idx].append((frag, kind, cb))
        self._kick_axi()

    def submit_control(self, nbytes: int = 64,
                       cb: Optional[Callable] = None) -> None:
        """EQ/control message: highest IO priority (R5)."""
        self.axi_ctrl.append((nbytes, cb))
        self._kick_axi()

    def _axi_pick(self):
        """Next (tenant, frag, kind, cb) per arbitration policy, or None."""
        if self.arb == "fifo":
            return self.axi_fifo.popleft() if self.axi_fifo else None
        pending = np.array([len(q) > 0 for q in self.axi_q])
        if not pending.any():
            return None
        head = np.array([q[0][0].nbytes if q else 0 for q in self.axi_q],
                        float)
        tr = self.trace
        d0 = self.dwrr.deficit.copy() if tr is not None else None
        i = W.dwrr_select(self.dwrr, head, pending,
                          quantum=float(self.frag.fragment_bytes))
        if i < 0:
            return None
        if tr is not None:
            TR.record_dwrr_grant(tr, self.now, TR.K_AXI_DWRR, i, d0,
                                 pending, self.dwrr.weights)
        frag, kind, cb = self.axi_q[i].popleft()
        return i, frag, kind, cb

    def _kick_axi(self) -> None:
        if self.axi_busy:
            return
        ns_per_b = self.hw.wire_ns_per_byte(self.hw.axi_gbps)
        if self.axi_ctrl:
            nbytes, cb = self.axi_ctrl.popleft()
            self.axi_busy = True

            def done_ctrl():
                self.axi_busy = False
                if cb:
                    cb(self.now)
                self._kick_axi()
            self._post(self.now + nbytes * ns_per_b, done_ctrl)
            return
        picked = self._axi_pick()
        if picked is None:
            return
        i, frag, kind, cb = picked
        overhead = (self.frag.hw_overhead_cycles
                    if self.frag.mode == "hardware" else 0)
        dur = frag.nbytes * ns_per_b + self.hw.cycles_ns(overhead)
        self.axi_busy = True

        def done():
            self.axi_busy = False
            if kind == "egress":
                self._egress_enqueue(i, frag, cb)
            else:
                self._io_bytes_cum[i] += frag.nbytes
                self._win_io[i] += frag.nbytes
                self.stats[i].io_bytes_done += frag.nbytes
                if cb is not None:
                    cb(self.now)
            self._kick_axi()

        self._post(self.now + dur, done)

    def _egress_enqueue(self, idx, frag, cb) -> None:
        if self.arb == "fifo":
            self.egress_fifo.append((idx, frag, cb))
        else:
            self.egress_q[idx].append((frag, cb))
        self._kick_egress()

    def _egress_pick(self):
        if self.arb == "fifo":
            return self.egress_fifo.popleft() if self.egress_fifo else None
        pending = np.array([len(q) > 0 for q in self.egress_q])
        if not pending.any():
            return None
        head = np.array([q[0][0].nbytes if q else 0 for q in self.egress_q],
                        float)
        tr = self.trace
        d0 = self.egress_dwrr.deficit.copy() if tr is not None else None
        i = W.dwrr_select(self.egress_dwrr, head, pending,
                          quantum=float(self.frag.fragment_bytes))
        if i < 0:
            return None
        if tr is not None:
            TR.record_dwrr_grant(tr, self.now, TR.K_EGRESS_DWRR, i, d0,
                                 pending, self.egress_dwrr.weights)
        frag, cb = self.egress_q[i].popleft()
        return i, frag, cb

    def _kick_egress(self) -> None:
        if self.egress_busy:
            return
        picked = self._egress_pick()
        if picked is None:
            return
        i, frag, cb = picked
        dur = frag.nbytes * self.hw.wire_ns_per_byte(self.hw.egress_gbps)
        self.egress_busy = True

        def done():
            self.egress_busy = False
            self._io_bytes_cum[i] += frag.nbytes
            self._win_io[i] += frag.nbytes
            self.stats[i].io_bytes_done += frag.nbytes
            if cb is not None:
                cb(self.now)
            self._kick_egress()

        self._post(self.now + dur, done)

    # -- trace plane ---------------------------------------------------------
    def trace_flush(self, t: float) -> None:
        """End-of-run flush: the hot paths record whole lifecycles only
        at completion, so packets still queued or on a PU have no rows
        yet.  Walk the FMQ FIFOs (open FMQ spans) and the in-flight
        slot table (closed FMQ/GRANT plus an open PU or DMA span), in
        uid order so both sim datapaths emit identical flush rows."""
        tr = self.trace
        if tr is None:
            return
        ents = []
        for fmq in self.fmqs:
            for pd in fmq.fifo:
                ents.append((pd.meta, pd.tenant, pd.arrival,
                             TR.D_MARK if pd.ecn else TR.D_OK, None))
        free = set(self._tr_free)
        for slot in range(self.hw.num_pus):
            if slot in free:
                continue
            pd = self._tr_s_pkt[slot]
            ents.append((self._tr_s_uid[slot], pd.tenant, pd.arrival,
                         TR.D_MARK if pd.ecn else TR.D_OK,
                         (slot, self._tr_s_grant[slot],
                          self._tr_s_tcomp[slot])))
        for uid, ten, arr, adisp, m in sorted(ents,
                                              key=lambda e: e[0]):
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

    # -- main loop -----------------------------------------------------------
    def run(self, trace: List[TracePacket],
            horizon: Optional[float] = None) -> SimResult:
        for pkt in trace:
            self._post(pkt.time, (lambda p: (lambda: self._arrival(p)))(pkt))
        while self._events:
            t = self._events[0][0]
            if horizon is not None and t > horizon:
                break            # leave the event queued for a later run()
            t, _, fn = heapq.heappop(self._events)
            self._advance_to(t)
            self.now = t
            fn()
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
