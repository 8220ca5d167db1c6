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
from repro_torch.models import moe as M
from repro_torch.serving.call_graphs import CallGraphs
from repro_torch.serving.kv_cache import SlotManager
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.telemetry import G_IDX, GAUGES, tenant_report
from repro_torch.telemetry import trace as TR
from repro_torch.telemetry.clock import now_ns


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
    cuda_graphs: Optional[bool] = None  # ModelExecutor: decode and the
    #                                   granted-rows prefill replayed as
    #                                   CUDA graphs (serving/
    #                                   call_graphs.py).  None: where they
    #                                   capture (one CUDA device, no mesh,
    #                                   ServeFns.capturable); True:
    #                                   required (raises off the card);
    #                                   False: every call eager


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

    ``prefill`` takes the engine's whole ``(max_slots, prefill_chunk)``
    chunk, but computes only the rows it was given work for (``valid_n >
    0``, picked on the host from the array it already holds) through
    ``prefill_rows``: the engine fills at most ``prefill_slots_per_step``
    of them, and the other rows' outputs were thrown away.  Their cache
    rows get the whole chunk's pad entries, so nothing served changes.
    The whole chunk runs where every row is valid (gathering the rows
    would copy the whole cache for nothing) and where the serve functions
    have no ``prefill_rows`` (a mesh, a model with MoE layers that
    dispatches with ``gshard``: ``serve_step.py`` says why; the dropless
    ``grouped`` dispatch computes each row alone and takes it).  Either
    way it returns (B,) tokens; a row it did not compute reads 0.

    With its engine tracing, a model with MoE layers on one device also
    counts each call's routing (``models.moe.COUNTERS``, summed over its
    MoE layers on the device); the counts come back in the same copy as
    the call's tokens and are recorded under the call's span
    (``TraceRecorder.moe_counts``).

    On one CUDA device with no mesh, where the serve functions can be
    captured (``ServeFns.capturable``), or
    wherever ``ecfg.cuda_graphs`` is True, the decode call and the
    prefill of 1 to ``prefill_slots_per_step`` granted rows are captured
    as CUDA graphs when the executor is built, and replayed
    (``serving/call_graphs.py``): the same operations on the same cache,
    enqueued in one launch.  ``ecfg.cuda_graphs`` False keeps every call
    eager.  A call with its engine tracing runs eagerly, so that the
    routing spans and counters are recorded.  ``replayed`` and ``eager``
    count the calls of each kind (``decode``, ``prefill``) each way.
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
        self._moe = any(model_cfg.moe_layer_mask()) and mesh is None
        self._graphs = None
        self.replayed = {"decode": 0, "prefill": 0}
        self.eager = {"decode": 0, "prefill": 0}
        if self.replays(ecfg.cuda_graphs, self.device, mesh,
                        self.fns.capturable):
            self._graphs = CallGraphs(
                self.fns, self.params, self.cache, batch=ecfg.max_slots,
                chunk=ecfg.prefill_chunk,
                max_rows=ecfg.prefill_slots_per_step)
            self.reset(np.zeros(ecfg.max_slots, bool))

    @staticmethod
    def replays(cuda_graphs: Optional[bool], device: torch.device, mesh,
                capturable: bool) -> bool:
        """Whether an executor on ``device`` and ``mesh``, whose serve
        functions are ``capturable`` or not, replays its calls under
        ``EngineConfig.cuda_graphs``; True off one CUDA device raises."""
        one_card = device.type == "cuda" and mesh is None
        if cuda_graphs and not one_card:
            raise ValueError("cuda_graphs replays the calls of one CUDA "
                             f"device; this executor has {device} and "
                             f"mesh={mesh!r}")
        if cuda_graphs is None:
            return one_card and capturable
        return cuda_graphs

    def _dev(self, a):
        return torch.as_tensor(a, device=self.device)

    def _launch(self, tr, fn, args):
        """``fn`` on the params and the cache; under the route counters
        when tracing a one-device MoE model.  Returns (its outputs, the
        counters' device tensor or None)."""
        if tr is None or not self._moe:
            return fn(self.params, self.cache, *args), None
        with M.counting(self.device) as acc:
            return fn(self.params, self.cache, *args), acc

    @staticmethod
    def _readback(nxt, acc):
        """(tokens, route counts or None) on the host, in one copy."""
        if acc is None:
            return nxt.cpu().numpy(), None
        both = torch.cat([nxt.to(torch.int64), acc]).cpu().numpy()
        n = nxt.shape[0]
        return both[:n].astype(np.int32), both[n:]

    # Inside an engine step with tracing on, each call records its parts
    # as host spans: ``stage`` (the arrays to the device), ``launch``
    # (the serve function, its work enqueued) and ``readback`` (the
    # tokens to the host, the call's one wait for the device).  A
    # prefill's ``stage`` carries its valid rows and the rows it computes.
    def prefill(self, tokens, lengths, valid_n):
        tr = TR.bound()
        B, C = tokens.shape
        rows = np.flatnonzero(valid_n > 0)
        whole = self.fns.prefill_rows is None or len(rows) == B
        if tr is None and not whole and self._graphs is not None \
                and self._graphs.has_rows(len(rows), C):
            got = self._graphs.prefill_rows(rows, tokens, lengths, valid_n)
            out = np.zeros(B, np.int32)
            out[rows] = got.cpu().numpy()
            self.replayed["prefill"] += 1
            return out
        self.eager["prefill"] += 1
        if tr is not None:
            tr.host_begin(TR.H_PREFILL_STAGE, int(valid_n.sum()),
                          (B if whole else len(rows)) * C)
        if whole:
            fn, args = self.fns.prefill_chunk, (tokens, lengths, valid_n)
        else:
            fn, args = self.fns.prefill_rows, (rows, tokens, lengths,
                                               valid_n)
        args = [self._dev(a) for a in args]
        if tr is not None:
            tr.host_next(TR.H_PREFILL_LAUNCH)
        (nxt, _, self.cache), acc = self._launch(tr, fn, args)
        if tr is not None:
            tr.host_next(TR.H_PREFILL_READBACK)
        got, counts = self._readback(nxt, acc)
        if tr is not None:
            tr.host_end()
            if counts is not None:
                tr.moe_counts(counts)
        if whole:
            return got
        out = np.zeros(B, got.dtype)
        out[rows] = got
        return out

    def decode(self, tokens, lengths, active):
        tr = TR.bound()
        if tr is None and self._graphs is not None:
            self.replayed["decode"] += 1
            return self._graphs.decode(tokens, lengths, active).cpu().numpy()
        self.eager["decode"] += 1
        if tr is not None:
            tr.host_begin(TR.H_DECODE_STAGE)
        args = self._dev(tokens), self._dev(lengths), self._dev(active)
        if tr is not None:
            tr.host_next(TR.H_DECODE_LAUNCH)
        (nxt, self.cache), acc = self._launch(tr, self.fns.decode, args)
        if tr is not None:
            tr.host_next(TR.H_DECODE_READBACK)
        out, counts = self._readback(nxt, acc)
        if tr is not None:
            tr.host_end()
            if counts is not None:
                tr.moe_counts(counts)
        return out

    def reset(self, keep):
        tr = TR.bound()
        if tr is not None:
            tr.host_begin(TR.H_RESET_STAGE)
        keep = self._dev(keep)
        if tr is not None:
            tr.host_next(TR.H_RESET_LAUNCH)
        self.cache = self.fns.reset_slots(self.cache, keep)
        if tr is not None:
            tr.host_end()


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
                self.trace.host_request_end(uid, now_ns(), TR.D_REJECT)
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
            tr.host_request(uid, req.tenant_id, TR.H_REQ_QUEUE, now_ns())
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
        t_grant_ns = now_ns() if tr is not None else 0
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
                tr.host_request(uid, t, TR.H_REQ_PREFILL, t_grant_ns)
        # invalidate stale cache rows for every slot assigned this step in
        # ONE batched call (R3 isolation)
        if tr is not None:
            tr.host_begin(TR.H_EXE_RESET)
        self.exe.reset(keep)
        if tr is not None:
            tr.host_end()

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
            tr.host_request_end(uid, now_ns(), disp)
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
        if tr is not None:
            tr.host_begin(TR.H_EXE_PREFILL, int(valid_n.sum()), B * C)
        nxt = self.exe.prefill(tokens, self.lengths.copy(), valid_n)
        # the first token of a request whose prompt this chunk ends is on
        # the host when the call returns
        t_first_ns = tr.host_end() if tr is not None else 0
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
                if tr is not None:
                    tr.host_request(uid, r.tenant_id, TR.H_REQ_DECODE,
                                    t_first_ns)
            if self._over_total_budget(r.tenant_id):
                self._finish(s, RequestStatus.KILLED,
                             kill_kind=EventKind.TOTAL_BUDGET_EXCEEDED)

    def _decode_phase(self) -> None:
        active = np.array([
            r is not None and r.status == RequestStatus.DECODE
            for r in self.slot_req])
        if not active.any():
            return
        tr = self.trace
        if tr is not None:
            tr.host_begin(TR.H_EXE_DECODE, int(active.sum()), active.size)
        nxt = self.exe.decode(self.last_tok.copy(), self.lengths.copy(),
                              active)
        if tr is not None:
            tr.host_end()
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
        tr = self.trace
        if tr is None:
            self._step(None)
            return
        # with tracing on, the step and its phases are host spans, and
        # the executor's calls record theirs into this step's recorder,
        # bound for the step alone: a step that raises leaves no
        # recorder bound and no span open
        TR.bind(tr)
        try:
            self._step(tr)
        finally:
            TR.bind(None)
            tr.host_unwind()

    def _step(self, tr: Optional[TR.TraceRecorder]) -> None:
        if tr is not None:
            tr.host_root(TR.H_STEP)
            tr.host_begin(TR.H_CONTROL)
        # R5: control traffic first
        while self._control:
            self._control.popleft()()
        if tr is not None:
            tr.host_next(TR.H_ASSIGN)
        self._assign_slots()
        if tr is not None:
            tr.host_next(TR.H_PREFILL)
        self._prefill_phase()
        if tr is not None:
            tr.host_next(TR.H_DECODE)
        self._decode_phase()
        if tr is not None:
            tr.host_next(TR.H_ACCOUNT)
        # WLBVT accounting + fairness (per engine step = one "cycle")
        W.advance(self.st, 1.0)
        act = self.st.active & self._installed
        if act.sum() >= 2:
            self.fairness.update(
                self.st.cur_occup[act], 1.0,
                weights=self.st.prio[act])
        if self.tel is not None:
            self._commit_telemetry()
        if tr is not None:
            tr.maybe_commit()
            tr.host_end()
            tr.host_end()
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
