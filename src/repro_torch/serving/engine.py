"""OSMOSIS multi-tenant serving engine (the paper's §5 on a GPU).

Control plane (host, this module)      | Data plane (PyTorch on the card)
---------------------------------------+----------------------------------
ECTX admission + static KV quotas (R3) | batched chunked prefill
WLBVT slot scheduler          (R1, R4) | batched decode (1 token/step)
DWRR prefill-token arbitration    (R2) | slot-cache reset
watchdog budgets + EQ events      (R5) |
priority SLO knobs                (R6) |

Mapping: packet = request chunk; PU = batch slot; kernel = the model's
execution for that chunk (cost unknown a priori — prompt and output
lengths differ per tenant, exactly the paper's unpredictable-kernel
problem); DMA fragmentation = chunked prefill; egress WRR = per-step
prefill token budget.  Scheduling state is the WLBVT/DWRR core in
``core/wlbvt.py``.

Run-to-completion: one scheduled chunk = one data-plane call; the engine
never preempts inside a step (paper §5.3).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import wlbvt as W
from repro_torch.core.accounting import TimeAveragedJain
from repro_torch.core.admission import AdmissionError
from repro_torch.core.engine_base import EngineBase
from repro_torch.core.events import Event, EventKind
from repro_torch.core.slo import ECTX, SLOPolicy
from repro_torch.serving.kv_cache import SlotManager
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.telemetry import G_IDX, GAUGES, tenant_report
from repro_torch.telemetry import trace as TR


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8                # "PUs": concurrent batch slots
    max_len: int = 512                # KV tokens per slot
    prefill_chunk: int = 64           # fragmentation grain (R2)
    prefill_slots_per_step: int = 2   # per-step prefill budget (PPB analog)
    scheduler: str = "wlbvt"          # "wlbvt" | "rr" (baseline)
    arbiter: str = "dwrr"             # "dwrr" | "fifo" (baseline)
    max_tenants: int = 128            # FMQ table size; decisions are O(T)
    #                                   vectorized so headroom is cheap
    kv_overcommit: float = 1.0        # R3: 1.0 = strict static reservation
    telemetry: bool = True            # per-tenant metric plane (DESIGN.md §6)
    telemetry_backend: str = "numpy"  # "numpy" | "torch" (state on the
    #                                   executor's device, commits with no
    #                                   host sync)
    qos_interval: int = 0             # steps between QoS control updates;
    #                                   0 = static weights (no control loop)
    observe_interval: int = 0         # steps between metrics-bus frames;
    #                                   0 = follow qos_interval (or 16
    #                                   without a controller).  Only paid
    #                                   when a bus/SLO audit is attached.
    trace: bool = False               # packet-lifecycle flight recorder
    trace_depth: int = 65536          # span ring depth (DESIGN.md §10)
    trace_decision_depth: int = 8192  # decision-provenance ring depth


class NullExecutor:
    """Scheduling-only backend (no model): deterministic fake tokens.

    It has no device, so a ``"torch"`` telemetry backend keeps its state
    on the card by default."""

    def __init__(self, cfg: EngineConfig):
        self.B = cfg.max_slots

    def prefill(self, tokens, lengths, valid_n):
        return np.zeros(self.B, np.int32)

    def decode(self, tokens, lengths, active):
        return (tokens + 1).astype(np.int32) % 97

    def reset(self, keep):
        pass


class ModelExecutor:
    """Real data plane: the model's prefill/decode/reset on a device.

    Host numpy arrays cross to ``device`` with ``torch.as_tensor`` and the
    sampled tokens come back with ``.cpu().numpy()``.  ``device`` is the
    card unless the caller asks for ``"cpu"``; without a card the default
    raises instead of falling back.

    ``mesh`` (a ``DeviceMesh``, as the JAX package's executor takes one):
    every rank runs the same engine on the same (B,) arrays; the serve
    functions take each rank's rows and gather the sampled tokens back,
    so every rank's engine sees the same stream.
    """

    def __init__(self, model_cfg: ModelConfig, ecfg: EngineConfig,
                 params=None, rng_seed: int = 0, temperature: float = 0.0,
                 device="cuda", mesh=None):
        self.fns = build_serve_fns(
            model_cfg, mesh, batch=ecfg.max_slots, max_len=ecfg.max_len,
            prefill_chunk=ecfg.prefill_chunk, temperature=temperature,
            device=device)
        self.device = self.fns.device
        self.params = (self.fns.place(params) if params is not None
                       else self.fns.init_params(rng_seed))
        self.cache = self.fns.init_cache()

    def _dev(self, a):
        return torch.as_tensor(a, device=self.device)

    def prefill(self, tokens, lengths, valid_n):
        nxt, _, self.cache = self.fns.prefill_chunk(
            self.params, self.cache, self._dev(tokens), self._dev(lengths),
            self._dev(valid_n))
        return nxt.cpu().numpy()

    def decode(self, tokens, lengths, active):
        nxt, self.cache = self.fns.decode(
            self.params, self.cache, self._dev(tokens), self._dev(lengths),
            self._dev(active))
        return nxt.cpu().numpy()

    def reset(self, keep):
        self.cache = self.fns.reset_slots(self.cache, self._dev(keep))


class Engine(EngineBase):
    OBS_BACKEND = "serve"

    def __init__(self, ecfg: EngineConfig, executor=None):
        # tenant/budget/EQ/telemetry plumbing is the shared engine-core
        # layer (core/engine_base.py)
        T = ecfg.max_tenants
        self.exe = executor or NullExecutor(ecfg)
        super().__init__(T, shared_eq=False, telemetry=ecfg.telemetry,
                         telemetry_backend=ecfg.telemetry_backend,
                         trace=ecfg.trace, trace_depth=ecfg.trace_depth,
                         trace_decision_depth=ecfg.trace_decision_depth,
                         trace_pus=ecfg.max_slots,
                         telemetry_device=getattr(self.exe, "device", None))
        self.cfg = ecfg
        self.ectx = self.ectxs          # legacy aliases for the public
        self.eq = self.eqhub.queues     # surface (dict views, shared state)
        self.tokens_used = self.budget.spent
        self.slots = SlotManager(ecfg.max_slots, ecfg.max_len,
                                 overcommit=ecfg.kv_overcommit)
        self.queues: Dict[int, deque] = {}
        self.st = W.WLBVTState.create(np.ones(T))
        self.rr_ptr = 0
        self.dwrr = W.DWRRState.create(np.ones(T))
        # slot state (numpy mirrors of device state)
        S = ecfg.max_slots
        self.slot_req: List[Optional[Request]] = [None] * S
        self.lengths = np.zeros(S, np.int32)
        self.last_tok = np.zeros(S, np.int32)
        self.step_count = 0
        self._next_rid = 0
        self._control: deque = deque()
        self.fairness = TimeAveragedJain()
        self.done: List[Request] = []
        self.decode_steps = 0
        self.prefill_chunks = 0
        # SLO-configured base weights per knob (tracked through ECTX
        # create/destroy); the controller scales these, never overwrites
        self._prio_base = np.ones(T)
        self._dwrr_base = np.ones(T)
        # flight-recorder bookkeeping (DESIGN.md §10): packet uid =
        # submission order; rid -> uid survives until EQ_COMPLETE
        self._tr_uid = 0
        self._tr_uid_by_rid: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # control plane (R5: processed before data-path work each step)
    # ------------------------------------------------------------------
    def create_ectx(self, tenant_id: int, slo: SLOPolicy,
                    name: str = "") -> ECTX:
        """Admission: static KV segment + FMQ install.  Raises
        AdmissionError when the quota does not fit (R3)."""
        if tenant_id in self.ectx:
            raise AdmissionError(f"tenant {tenant_id} already admitted")
        if tenant_id >= self.cfg.max_tenants:
            raise AdmissionError("FMQ table full")
        self.slots.admit(tenant_id, slo.kv_quota_tokens)
        e = ECTX(tenant_id=tenant_id, name=name or f"tenant{tenant_id}",
                 slo=slo)
        self.queues[tenant_id] = deque()
        self.st.prio[tenant_id] = slo.priority
        self.dwrr.weights[tenant_id] = slo.dma_priority
        self._prio_base[tenant_id] = slo.priority
        self._dwrr_base[tenant_id] = slo.dma_priority
        return self.register_tenant(e, fmq_index=tenant_id, announce=True,
                                    now=self.step_count)

    def destroy_ectx(self, tenant_id: int) -> List[Event]:
        """Tear down a tenant: kill in-flight requests, reject queued ones
        (each with an event), release the KV segment, and retire the
        tenant's EventQueue.  Returns the final drained event list — the
        queue itself is removed, so this is the last chance to observe
        the tenant's events."""
        for s, r in enumerate(self.slot_req):
            if r is not None and r.tenant_id == tenant_id:
                self._finish(s, RequestStatus.KILLED)
        eq = self.eqhub.retire(tenant_id)
        for req in self.queues.pop(tenant_id, ()):
            req.status = RequestStatus.REJECTED
            req.finish_step = self.step_count
            if self.trace is not None:
                uid = self._tr_uid_by_rid.pop(req.rid, -1)
                self.trace.span_abandon(TR.ST_FMQ, uid,
                                        float(self.step_count),
                                        TR.D_REJECT)
            self.done.append(req)
            if eq is not None:
                eq.push(Event(tenant_id, EventKind.EVICTED, self.step_count,
                              f"rid={req.rid} rejected: ectx destroyed"))
        self.slots.evict(tenant_id)
        # registry row, admission gate, budget, telemetry + controller
        # history: one shared teardown (core/engine_base.py)
        self.deregister_tenant(tenant_id)
        self._prio_base[tenant_id] = 1.0
        self._dwrr_base[tenant_id] = 1.0
        self.st.queue_len[tenant_id] = 0
        self.st.prio[tenant_id] = 1.0
        self.st.total_occup[tenant_id] = 0.0   # a reused tenant id must not
        self.st.bvt[tenant_id] = 0.0           # inherit WLBVT service history
        self.dwrr.deficit[tenant_id] = 0.0
        if eq is not None:
            eq.push(Event(tenant_id, EventKind.EVICTED, self.step_count))
            return eq.drain()
        return []

    def attach_controller(self, controller) -> None:
        """Install a ``QoSController``; it runs every ``qos_interval``
        steps, adapting WLBVT/DWRR weights and the admission gate."""
        if self.tel is None or self.cfg.qos_interval <= 0:
            raise ValueError(
                "attach_controller requires EngineConfig.telemetry=True "
                "and qos_interval > 0 — the control loop would never run")
        self.controller = controller

    def submit(self, req: Request) -> Request:
        if req.tenant_id not in self.ectx:
            req.status = RequestStatus.REJECTED
            return req
        if self.tel is not None:
            self.tel.inc("arrivals", req.tenant_id)
            self.tel.inc("bytes_in", req.tenant_id, req.prompt_len)
        tr = self.trace
        uid = -1
        if tr is not None:
            uid = self._tr_uid
            self._tr_uid += 1
        if not self._admit[req.tenant_id]:
            # QoS controller backpressure (hysteresis on congestion)
            req.status = RequestStatus.REJECTED
            self._reject_count(req.tenant_id)
            if tr is not None:
                self._trace_reject(uid, req.tenant_id)
            self.eq[req.tenant_id].push(Event(
                req.tenant_id, EventKind.BACKPRESSURE, self.step_count))
            return req
        # Lifetime billing budget (R5): a tenant whose total token spend
        # exhausted its allowance gets no further admission.
        tlimit = self.ectx[req.tenant_id].slo.total_cycle_limit
        if self.budget.exhausted(req.tenant_id, tlimit):
            req.status = RequestStatus.REJECTED
            self._reject_count(req.tenant_id)
            if tr is not None:
                self._trace_reject(uid, req.tenant_id)
            self.eq[req.tenant_id].push(Event(
                req.tenant_id, EventKind.TOTAL_BUDGET_EXCEEDED,
                self.step_count,
                f"lifetime budget {tlimit} tokens exhausted"))
            return req
        if req.prompt_len + req.max_new_tokens > self.cfg.max_len:
            req.status = RequestStatus.REJECTED
            self._reject_count(req.tenant_id)
            if tr is not None:
                self._trace_reject(uid, req.tenant_id)
            self.eq[req.tenant_id].push(Event(
                req.tenant_id, EventKind.MEMORY_FAULT, self.step_count,
                "request exceeds slot KV capacity"))
            return req
        # Watchdog admission check (R5): a request whose prompt alone blows
        # the kernel cycle budget would be killed at its first decode token
        # — reject it up front instead of burning prefill work on it.
        limit = self.ectx[req.tenant_id].slo.kernel_cycle_limit
        if limit and req.prompt_len + 1 > limit:
            req.status = RequestStatus.REJECTED
            self._reject_count(req.tenant_id)
            if tr is not None:
                self._trace_reject(uid, req.tenant_id)
            self.eq[req.tenant_id].push(Event(
                req.tenant_id, EventKind.CYCLE_BUDGET_EXCEEDED,
                self.step_count,
                f"prompt {req.prompt_len} cannot fit cycle budget {limit}"))
            return req
        req.rid = self._next_rid
        self._next_rid += 1
        req.arrival_step = self.step_count
        if tr is not None:
            now = float(self.step_count)
            tr.span(TR.ST_ARRIVE, uid, req.tenant_id, now, now, TR.D_OK)
            tr.span_begin(TR.ST_FMQ, uid, req.tenant_id, now)
            self._tr_uid_by_rid[req.rid] = uid
        self.queues[req.tenant_id].append(req)
        self.st.queue_len[req.tenant_id] += 1
        return req

    def _reject_count(self, tenant_id: int) -> None:
        if self.tel is not None:
            self.tel.inc("rejected", tenant_id)

    def _trace_reject(self, uid: int, tenant_id: int) -> None:
        now = float(self.step_count)
        self.trace.span(TR.ST_ARRIVE, uid, tenant_id, now, now, TR.D_REJECT)
        TR.record_admission_reject(self.trace, now, tenant_id)

    def poll_events(self, tenant_id: int) -> List[Event]:
        return self.eqhub.poll(tenant_id)

    # ------------------------------------------------------------------
    # data plane step
    # ------------------------------------------------------------------
    def _select_round(self, k: int) -> List[int]:
        """The winners of one scheduling round: up to ``k`` tenant picks,
        KV-quota caps folded into eligibility vectorially (R1 + R3).
        ``st.queue_len``/``st.cur_occup`` are charged per pick."""
        caps = self.slots.quota_caps(self.cfg.max_tenants)
        tr = self.trace
        now = float(self.step_count)
        if self.cfg.scheduler == "rr":
            picks: List[int] = []
            for _ in range(k):
                i, ptr = W.select_rr(self.rr_ptr, self.st.queue_len,
                                     mask=self.st.cur_occup < caps)
                if i < 0:
                    break
                if tr is not None:
                    TR.record_rr_pick(
                        tr, now, TR.K_PU_RR, i,
                        np.where(self.st.cur_occup < caps,
                                 self.st.queue_len, 0),
                        self.st.bvt)
                self.rr_ptr = ptr
                self.st.queue_len[i] -= 1
                self.st.cur_occup[i] += 1
                picks.append(i)
            return picks
        if tr is None:
            return [int(t) for t in
                    W.select_k(self.st, self.cfg.max_slots, k, cap=caps)
                    if t >= 0]
        # decision provenance (DESIGN.md §10): stage picks + post-round
        # state; commit reconstructs the pre-round arrays — the
        # scheduler itself stays untouched
        picks = [int(t) for t in
                 W.select_k(self.st, self.cfg.max_slots, k, cap=caps)
                 if t >= 0]
        TR.record_wlbvt_round(tr, now, self.st, picks, self.cfg.max_slots,
                              TR.K_PU_WLBVT, cap=caps)
        return picks

    def _assign_slots(self) -> None:
        k = int(self.slots.free_slots().size)
        if k == 0:
            return
        picks = self._select_round(k)
        if not picks:
            return
        keep = np.ones(self.cfg.max_slots, bool)
        tr = self.trace
        for t in picks:
            req = self.queues[t].popleft()
            s = self.slots.take(t)
            req.slot = s
            req.status = RequestStatus.PREFILL
            req.start_step = self.step_count
            self.slot_req[s] = req
            self.lengths[s] = 0
            keep[s] = False
            if tr is not None:
                uid = self._tr_uid_by_rid.get(req.rid, -1)
                now = float(self.step_count)
                tr.span_end(TR.ST_FMQ, uid, now, TR.D_OK, pu=s)
                tr.span(TR.ST_GRANT, uid, t, now, now, TR.D_OK, pu=s)
        # invalidate stale cache rows for every slot assigned this step in
        # ONE batched call (R3 isolation)
        self.exe.reset(keep)

    def _finish(self, slot: int, status: RequestStatus,
                kill_kind: EventKind = EventKind.REQUEST_KILLED) -> None:
        req = self.slot_req[slot]
        req.status = status
        req.finish_step = self.step_count
        t = req.tenant_id
        tr = self.trace
        if tr is not None:
            uid = self._tr_uid_by_rid.pop(req.rid, -1)
            now = float(self.step_count)
            killed = status == RequestStatus.KILLED
            disp = TR.D_KILL if killed else TR.D_OK
            tr.span(TR.ST_PU, uid, t, float(req.start_step), now, disp,
                    pu=slot)
            tr.span(TR.ST_EQ, uid, t, now, now, disp, pu=slot)
        self.st.cur_occup[t] -= 1
        self.slots.release(slot)
        self.slot_req[slot] = None
        self.done.append(req)
        if self.tel is not None:
            killed = status == RequestStatus.KILLED
            self.tel.inc("killed" if killed else "completed", t)
            if not killed:
                self.tel.inc("bytes_out", t, len(req.generated))
            self.tel.lat(t, max(req.fct, 1))   # sojourn incl. queueing
        if status == RequestStatus.KILLED:
            self.eq[t].push(Event(t, kill_kind, self.step_count,
                                  f"rid={req.rid}"))

    def _prefill_phase(self) -> None:
        """Chunked prefill with DWRR tenant arbitration (R2): at most
        ``prefill_slots_per_step`` slots advance one fragment per step."""
        C = self.cfg.prefill_chunk
        tr = self.trace
        pending_slots: Dict[int, List[int]] = {}
        for s, r in enumerate(self.slot_req):
            if r is not None and r.status == RequestStatus.PREFILL:
                pending_slots.setdefault(r.tenant_id, []).append(s)
        if not pending_slots:
            return
        chosen: List[int] = []
        if self.cfg.arbiter == "fifo":
            # no-QoS baseline: oldest requests first regardless of tenant
            order = sorted(
                (s for ss in pending_slots.values() for s in ss),
                key=lambda s: self.slot_req[s].rid)
            chosen = order[: self.cfg.prefill_slots_per_step]
        else:
            T = self.cfg.max_tenants
            counts = np.zeros(T, np.int64)
            for i, ss in pending_slots.items():
                counts[i] = len(ss)
            head = np.full(T, float(C))
            d0 = self.dwrr.deficit.copy() if tr is not None else None
            c0 = counts.copy() if tr is not None else None
            picks = W.dwrr_select_k(self.dwrr, head, counts,
                                    quantum=float(C),
                                    k=self.cfg.prefill_slots_per_step)
            if tr is not None:
                TR.record_dwrr_round(
                    tr, float(self.step_count), TR.K_AXI_DWRR,
                    [int(i) for i in picks if i >= 0], d0, c0,
                    self.dwrr.weights)
            chosen = [pending_slots[int(i)].pop(0) for i in picks if i >= 0]

        if not chosen:
            return
        B = self.cfg.max_slots
        tokens = np.zeros((B, C), np.int32)
        valid_n = np.zeros(B, np.int32)
        for s in chosen:
            r = self.slot_req[s]
            n = min(C, r.prompt_len - r.prefill_done)
            tokens[s, :n] = r.prompt[r.prefill_done:r.prefill_done + n]
            valid_n[s] = n
        nxt = self.exe.prefill(tokens, self.lengths.copy(), valid_n)
        self.prefill_chunks += 1
        for s in chosen:
            r = self.slot_req[s]
            n = int(valid_n[s])
            r.prefill_done += n
            self.lengths[s] += n
            self._charge_tokens(r.tenant_id, n)
            r.chunk_steps.append(self.step_count)
            if tr is not None:
                # chunked prefill is the DMA-fragmentation analog: one
                # zero-width DMA marker per fragment (step clock has no
                # intra-step duration, so PU+FMQ still reconcile exactly)
                uid = self._tr_uid_by_rid.get(r.rid, -1)
                now = float(self.step_count)
                tr.span(TR.ST_DMA, uid, r.tenant_id, now, now, TR.D_OK,
                        pu=s)
            if r.prefill_done >= r.prompt_len:
                r.status = RequestStatus.DECODE
                r.generated.append(int(nxt[s]))
                self.last_tok[s] = nxt[s]
            if self._over_total_budget(r.tenant_id):
                self._finish(s, RequestStatus.KILLED,
                             kill_kind=EventKind.TOTAL_BUDGET_EXCEEDED)

    def _decode_phase(self) -> None:
        active = np.array([
            r is not None and r.status == RequestStatus.DECODE
            for r in self.slot_req])
        if not active.any():
            return
        nxt = self.exe.decode(self.last_tok.copy(), self.lengths.copy(),
                              active)
        self.decode_steps += 1
        for s in np.flatnonzero(active):
            r = self.slot_req[s]
            self.lengths[s] += 1
            r.generated.append(int(nxt[s]))
            self.last_tok[s] = nxt[s]
            self._charge_tokens(r.tenant_id, 1)
            limit = self.ectx[r.tenant_id].slo.kernel_cycle_limit
            if self._over_total_budget(r.tenant_id):
                self._finish(s, RequestStatus.KILLED,
                             kill_kind=EventKind.TOTAL_BUDGET_EXCEEDED)
            elif limit and r.total_tokens > limit:
                self._finish(s, RequestStatus.KILLED)
            elif len(r.generated) >= r.max_new_tokens:
                self._finish(s, RequestStatus.DONE)

    def _charge_tokens(self, tenant: int, n: int) -> None:
        self.budget.charge(tenant, n)
        if self.tel is not None:
            self.tel.inc("tokens", tenant, n)

    def _over_total_budget(self, tenant: int) -> bool:
        t = self.ectx.get(tenant)
        return t is not None and self.budget.over_total(
            tenant, t.slo.total_cycle_limit)

    def _kv_pressure(self) -> np.ndarray:
        caps = self.slots.quota_caps(self.cfg.max_tenants)
        held = np.bincount(self.slots.slot_tenant[self.slots.slot_tenant >= 0],
                           minlength=self.cfg.max_tenants)
        return held / np.maximum(caps, 1)

    def _commit_telemetry(self) -> None:
        """Per-step telemetry flush + gauge window: one counter/latency
        commit and one ring push — on the ``"torch"`` backend one upload
        and a few launches each, so the data plane never syncs."""
        tel = self.tel
        gauges = np.zeros((len(GAUGES), self.cfg.max_tenants))
        gauges[G_IDX["occupancy"]] = self.st.cur_occup
        gauges[G_IDX["queue_len"]] = self.st.queue_len
        gauges[G_IDX["service_rate"]] = tel.staged("tokens")
        gauges[G_IDX["kv_pressure"]] = self._kv_pressure()
        tel.commit()
        tel.commit_window(gauges)
        obs_every = (self.cfg.observe_interval or self.cfg.qos_interval
                     or 16)
        if (self.step_count > 0 and self.step_count % obs_every == 0):
            self.observe_tick(
                t=float(self.step_count), prio=self.st.prio,
                total_occup=self.st.total_occup, bvt=self.st.bvt,
                kv_pressure=gauges[G_IDX["kv_pressure"]])
        if (self.controller is not None and self.cfg.qos_interval
                and self.step_count > 0
                and self.step_count % self.cfg.qos_interval == 0):
            self.qos_tick(
                prio=self.st.prio, total_occup=self.st.total_occup,
                bvt=self.st.bvt, kv_pressure=gauges[G_IDX["kv_pressure"]],
                knobs=((self.st.prio, self._prio_base),
                       (self.dwrr.weights, self._dwrr_base)),
                installed=self._installed,
                t=float(self.step_count))

    def step(self) -> None:
        # R5: control traffic first
        while self._control:
            self._control.popleft()()
        self._assign_slots()
        self._prefill_phase()
        self._decode_phase()
        # WLBVT accounting + fairness (per engine step = one "cycle")
        W.advance(self.st, 1.0)
        act = self.st.active & self._installed
        if act.sum() >= 2:
            self.fairness.update(
                self.st.cur_occup[act], 1.0,
                weights=self.st.prio[act])
        if self.tel is not None:
            self._commit_telemetry()
        if self.trace is not None:
            self.trace.maybe_commit()
        self.step_count += 1

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            busy = any(r is not None for r in self.slot_req) or \
                any(len(q) for q in self.queues.values())
            if not busy:
                return
            self.step()
        raise RuntimeError("engine did not drain")  # pragma: no cover

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Untyped engine counters.

        Deprecated as a public surface: external consumers should run
        through ``repro_torch.api`` (``ServeRuntime``/``run_scenario``) and
        consume the schema-validated ``RunReport`` instead (DESIGN.md
        §7)."""
        per_tenant: Dict[int, Dict[str, float]] = {}
        for r in self.done:
            d = per_tenant.setdefault(r.tenant_id, {
                "done": 0, "killed": 0, "fct_sum": 0.0, "tokens": 0})
            if r.status == RequestStatus.DONE:
                d["done"] += 1
                d["fct_sum"] += r.fct
                d["tokens"] += r.total_tokens
            else:
                d["killed"] += 1
        for t, d in per_tenant.items():
            d["mean_fct"] = d["fct_sum"] / max(d["done"], 1)
        return {
            "steps": self.step_count,
            "jain_timeavg": self.fairness.value,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "tenants": per_tenant,
        }

    def telemetry_report(self) -> Dict[str, Any]:
        """Per-tenant telemetry plane report (latency units = steps)."""
        if self.tel is None:
            return {"telemetry": "disabled"}
        self.tel.commit()
        names = {t: e.name for t, e in self.ectx.items()}
        return tenant_report(self.tel, names=names)
