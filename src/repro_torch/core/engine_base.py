"""Shared engine-core layer: one tenant/budget/EQ/telemetry plumbing
stack for every execution engine — the cycle simulator
(``sim/engine.py``), its batched datapath (``sim/fastpath.py``) and the
serving engine (``serving/engine.py``).

  * ``BudgetLedger``    — per-tenant lifetime spend (PU cycles on the
    simulator, tokens on the serving engine) plus the watchdog clamp
    semantics of §5.2/§5.3: a kernel is truncated at its per-kernel
    cycle budget, and at the tenant's remaining *total* allowance (the
    permanent form of the same mechanism).
  * ``EQHub``           — per-ECTX event-queue delivery in both layouts
    the engines use: one shared chronological queue (the simulator's
    ``SimResult.events``) or one ``EventQueue`` per tenant (the serving
    engine's ``poll_events`` surface, with retire-on-destroy).
  * ``EngineBase``      — ECTX registry (dense tenant table + installed
    mask), the telemetry plane (staging wrapper + window commits), the
    admission gate, the QoS controller tick (signal read → AIMD update →
    weight actuation → admit mask), the SLO burn-rate audit, the metrics
    bus publish and the trace recorder (flight recorder + decision
    provenance).

Backends remain free in *when* they invoke these mechanisms (the
simulator at virtual-time window boundaries, the serving engine once per
step); the mechanisms themselves exist once.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.events import Event, EventKind, EventQueue
from repro_torch.core.slo import ECTX


class BudgetLedger:
    """Per-tenant lifetime spend + the paper's watchdog clamp semantics.

    The unit is backend-defined (PU cycles on the simulator, tokens on
    the serving engine); the logic is shared.
    """

    def __init__(self, num_tenants: int):
        self.spent = np.zeros(num_tenants)

    # -- simulator surface: clamp a kernel's cost before execution ---------
    @staticmethod
    def clamp_kernel(cost: float, limit: float) -> tuple:
        """Per-kernel watchdog (§5.3): returns ``(cost, killed)`` with the
        cost truncated at ``limit`` (0 = unlimited)."""
        if limit and cost > limit:
            return float(limit), True
        return cost, False

    def clamp_total(self, tenant: int, cost: float, limit: float) -> tuple:
        """Lifetime-budget watchdog (billing, §5.2): truncate ``cost`` at
        the tenant's remaining total allowance and charge the ledger.
        Returns ``(cost, budget_killed)`` — exhaustion is permanent."""
        budget_killed = False
        if limit:
            remaining = float(limit) - self.spent[tenant]
            if cost > remaining:
                budget_killed = True
                cost = max(0.0, remaining)
        self.spent[tenant] += cost
        return cost, budget_killed

    # -- serving surface: incremental charging --------------------------------
    def charge(self, tenant: int, amount: float) -> None:
        self.spent[tenant] += amount

    def over_total(self, tenant: int, limit: float) -> bool:
        """Post-charge lifetime check (the serving engine charges per
        generated token, then kills)."""
        return bool(limit and self.spent[tenant] > limit)

    def exhausted(self, tenant: int, limit: float) -> bool:
        """Admission-time lifetime check (>=: a tenant that spent exactly
        its allowance gets no further admission)."""
        return bool(limit and self.spent[tenant] >= limit)

    def reset(self, tenant: int) -> None:
        """Budget is per tenant *identity*: a reused id starts fresh."""
        self.spent[tenant] = 0.0

    @staticmethod
    def kill_kind(budget_killed: bool) -> EventKind:
        return (EventKind.TOTAL_BUDGET_EXCEEDED if budget_killed
                else EventKind.CYCLE_BUDGET_EXCEEDED)


class EQHub:
    """Per-ECTX event-queue delivery (paper §5.2, R5) in both layouts.

    ``shared=True``  — one chronological queue for the whole engine (the
    simulator: events are produced in virtual-time order and drained
    into ``SimResult.events``).
    ``shared=False`` — one ``EventQueue`` per tenant with install/retire
    lifecycle (the serving engine's ``poll_events`` surface).
    """

    def __init__(self, *, shared: bool, capacity: int = 4096):
        self.shared = shared
        self.capacity = capacity
        self._q: Optional[EventQueue] = (EventQueue(capacity) if shared
                                         else None)
        self.queues: Dict[int, EventQueue] = {}

    def install(self, tenant: int) -> None:
        if not self.shared:
            self.queues[tenant] = EventQueue(self.capacity)

    def retire(self, tenant: int) -> Optional[EventQueue]:
        """Remove a tenant's queue (last chance to observe its events)."""
        return self.queues.pop(tenant, None)

    def __contains__(self, tenant: int) -> bool:
        return self.shared or tenant in self.queues

    def push(self, ev: Event) -> None:
        q = self._q if self.shared else self.queues.get(ev.tenant)
        if q is not None:
            q.push(ev)

    def poll(self, tenant: int) -> List[Event]:
        if self.shared:
            raise RuntimeError("shared EQHub drains globally, not per "
                               "tenant")
        return self.queues[tenant].drain()

    def drain_all(self) -> List[Event]:
        if not self.shared:
            raise RuntimeError("per-tenant EQHub is polled per tenant")
        return self._q.drain()

    def snapshot(self, tenant: int) -> List[Event]:
        q = self._q if self.shared else self.queues.get(tenant)
        return q.snapshot() if q is not None else []


class EngineBase:
    """Backend-agnostic tenant machinery shared by every engine.

    ``OBS_BACKEND`` labels the frames this engine publishes on the
    metrics bus ("sim" | "serve" — the serving engine overrides it).

    Owns the ECTX registry (dense table + installed mask), the budget
    ledger, the EQ hub, the telemetry plane, the admission gate, the QoS
    controller tick, the SLO audit, the bus and the trace recorder.
    Subclasses (``sim.engine.Simulator``,
    ``sim.fastpath.BatchedSimulator``, ``serving.engine.Engine``) keep
    only their execution semantics:
    *when* these mechanisms fire and what the data plane in between
    looks like.  ``telemetry_device`` is where a ``"torch"`` telemetry
    backend keeps its state (the serving engine passes its executor's
    device); the numpy backend ignores it.
    """

    OBS_BACKEND = "sim"

    def __init__(self, max_tenants: int, *, shared_eq: bool,
                 eq_capacity: int = 4096, telemetry: bool = True,
                 telemetry_backend: str = "numpy", trace: bool = False,
                 trace_depth: int = 65536,
                 trace_decision_depth: int = 8192, trace_pus: int = 0,
                 telemetry_device=None):
        from repro_torch.telemetry import Telemetry
        T = max_tenants
        self.max_tenants = T
        self.ectxs: Dict[int, ECTX] = {}
        self._installed = np.zeros(T, bool)
        self.budget = BudgetLedger(T)
        self.eqhub = EQHub(shared=shared_eq, capacity=eq_capacity)
        self.tel = (Telemetry(T, backend=telemetry_backend,
                              device=telemetry_device)
                    if telemetry else None)
        if trace:
            from repro_torch.telemetry.trace import TraceRecorder
            self.trace: Optional["TraceRecorder"] = TraceRecorder(
                T, num_pus=trace_pus, depth=trace_depth,
                decision_depth=trace_decision_depth)
        else:
            self.trace = None
        self.controller = None
        self._ctrl_baseline = None
        self._admit = np.ones(T, bool)       # controller backpressure gate
        # streaming observability plane: a MetricsBus
        # and/or SLO burn-rate audit attached via attach_bus /
        # attach_slo_audit; observe_tick publishes one frame per
        # backend observation interval against its own baseline (the
        # controller's interval differencing is untouched)
        self.bus = None
        self.slo_audit = None
        self._obs_baseline = None
        self._obs_seq = 0
        self.obs_nic = ""   # fleet runs tag shared-bus frames "nic<k>"

    # -- trace plane ---------------------------------------------------------
    def trace_flush(self, t: float) -> None:
        """Flush in-flight trace state at end of run: write every
        still-open span with disposition OPEN and commit.  Engines
        whose hot paths skip the open-span dict (the simulators record
        whole lifecycles at completion) override this to walk their
        queues and in-flight slots instead."""
        if self.trace is None:
            return
        self.trace.flush_open(t)
        self.trace.commit()

    # -- ECTX registry -------------------------------------------------------
    def register_tenant(self, e: ECTX, *, fmq_index: Optional[int] = None,
                        announce: bool = False, now: float = 0.0) -> ECTX:
        """Install one ECTX: dense-table row, EQ install, optional
        ``ADMITTED`` event.  The caller seeds its scheduler arrays."""
        tid = e.tenant_id
        if fmq_index is not None:
            e.fmq_index = fmq_index
        self.ectxs[tid] = e
        self._installed[tid] = True
        self.eqhub.install(tid)
        if announce:
            self.eqhub.push(Event(tid, EventKind.ADMITTED, now))
        return e

    def deregister_tenant(self, tenant: int) -> Optional[EventQueue]:
        """Uninstall one ECTX: registry row, installed bit, admission
        gate, budget, telemetry + controller history (a reused tenant id
        must not inherit any of them).  Returns the retired EventQueue
        (per-tenant layout) so the caller can flush final events."""
        self.ectxs.pop(tenant, None)
        self._installed[tenant] = False
        self._admit[tenant] = True
        self.budget.reset(tenant)
        if self.controller is not None:
            self.controller.reset_tenant(tenant, base_weight=1.0)
        if self.tel is not None:
            self.tel.reset_tenant(tenant)
            if self._ctrl_baseline is not None:
                self._ctrl_baseline["counts"][tenant] = 0
                self._ctrl_baseline["hist"][tenant] = 0
            if self._obs_baseline is not None:
                self._obs_baseline["counts"][tenant] = 0
                self._obs_baseline["hist"][tenant] = 0
        return self.eqhub.retire(tenant)

    @property
    def installed(self) -> np.ndarray:
        return self._installed

    def admitted(self, tenant: int) -> bool:
        """Controller backpressure gate (False = source-throttled)."""
        return bool(self._admit[tenant])

    # -- QoS control loop ----------------------------------------------------
    def qos_tick(self, *, prio, total_occup, bvt, kv_pressure,
                 knobs, installed: Optional[np.ndarray] = None,
                 t: float = 0.0) -> None:
        """One closed-loop controller interval (DESIGN.md §6): read the
        committed telemetry into a ``SignalFrame``, run the AIMD update,
        actuate the scheduler-weight ``knobs`` (``(live, base)`` pairs),
        and refresh the admission gate.  Call only when a controller is
        attached and the backend's interval elapsed.  ``t`` is the
        interval end in the backend's time unit; an attached SLO audit
        uses it to attribute alerts to the interventions this tick
        applies (which the trace plane also records)."""
        from repro_torch.telemetry import apply_to_scheduler, compute_signals
        snap = self.tel.snapshot()
        sig = compute_signals(
            self.tel, prio=prio, total_occup=total_occup, bvt=bvt,
            kv_pressure=kv_pressure, baseline=self._ctrl_baseline,
            snap=snap)
        self._ctrl_baseline = snap
        act = self.controller.update(sig)
        if self.slo_audit is not None:
            new_ivs = self.slo_audit.note_intervention(t, act, installed)
            if self.trace is not None and new_ivs:
                from repro_torch.telemetry.trace import (
                    record_qos_intervention)
                for iv in new_ivs:
                    record_qos_intervention(self.trace, t, iv["tenant"],
                                            iv["kind"], iv["value"])
        apply_to_scheduler(act, *knobs, installed=installed)
        self._admit = act.admit

    # -- streaming observability (DESIGN.md §11) -----------------------------
    def attach_bus(self, bus) -> None:
        """Attach a ``telemetry.bus.MetricsBus``; ``observe_tick``
        publishes one ``BusFrame`` per observation interval."""
        self.bus = bus

    def attach_slo_audit(self, audit) -> None:
        """Attach a ``telemetry.slo_audit.SLOAudit``; ``observe_tick``
        feeds it and pushes its alerts as ``SLO_ALERT`` EQ events."""
        self.slo_audit = audit

    def observe_tick(self, *, t: float, prio, total_occup, bvt,
                     kv_pressure) -> None:
        """One observation interval: difference the committed telemetry
        against the observer baseline, run the SLO audit (alerts land
        in the EQ stream and, when tracing, the decision ring), and
        publish a ``BusFrame``.  No-op (one attribute check) with
        nothing attached; reads only host-side committed state (the
        telemetry snapshot), so the commit path is untouched.  Backends call this *before*
        any same-boundary ``qos_tick`` so an alert raised at the
        boundary precedes the controller's intervention."""
        if self.bus is None and self.slo_audit is None:
            return
        from repro_torch.telemetry import compute_signals
        snap = self.tel.snapshot()
        sig = compute_signals(
            self.tel, prio=prio, total_occup=total_occup, bvt=bvt,
            kv_pressure=kv_pressure, baseline=self._obs_baseline,
            snap=snap)
        counts = snap["counts"]
        interval_counts = (counts - self._obs_baseline["counts"]
                           if self._obs_baseline is not None
                           else counts.copy())
        self._obs_baseline = snap
        alerts = ()
        if self.slo_audit is not None:
            alerts = self.slo_audit.observe(
                t=t, sig=sig, interval_counts=interval_counts)
            for a in alerts:
                self.eqhub.push(Event(
                    a.tenant, EventKind.SLO_ALERT, t,
                    detail=f"{a.window} burn={a.burn_rate:.3g} "
                           f"p99={a.p99:.6g} target={a.target:.6g}"))
            if self.trace is not None and alerts:
                from repro_torch.telemetry.trace import record_slo_alert
                for a in alerts:
                    record_slo_alert(self.trace, t, a.tenant, a.window,
                                     a.burn_rate)
        if self.bus is not None:
            from repro_torch.api.report import TIME_UNITS
            from repro_torch.telemetry.bus import BusFrame
            sim_unit, step_unit = TIME_UNITS
            self.bus.publish(BusFrame(
                t=float(t), seq=self._obs_seq,
                time_unit=(step_unit if self.OBS_BACKEND == "serve"
                           else sim_unit),
                backend=self.OBS_BACKEND,
                signals=sig, counts=counts,
                interval_counts=interval_counts,
                weights=np.array(prio, float),
                admit=self._admit.copy(), alerts=alerts,
                nic=self.obs_nic))
        self._obs_seq += 1
