"""Event queues (EQ) — paper §5.2: per-ECTX host notification channel.

EQ traffic shares the DMA path but at the *highest* IO priority (R5);
in the serving engine, control events are drained before data-path
scheduling each step.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, List, Optional


class EventKind(enum.Enum):
    KERNEL_ERROR = "kernel_error"
    CYCLE_BUDGET_EXCEEDED = "cycle_budget_exceeded"
    TOTAL_BUDGET_EXCEEDED = "total_budget_exceeded"
    MEMORY_FAULT = "memory_fault"
    QUEUE_OVERFLOW = "queue_overflow"
    ECN_MARK = "ecn_mark"
    BACKPRESSURE = "backpressure"
    REQUEST_KILLED = "request_killed"
    ADMITTED = "admitted"
    EVICTED = "evicted"
    SLO_ALERT = "slo_alert"
    MIGRATE_START = "migrate_start"
    MIGRATE_DONE = "migrate_done"
    SWITCH_DROP = "switch_drop"


# Where each kind is consumed once it leaves the EQ.  Every member MUST
# have a row here — ``repro_torch.analysis`` (eq-event-exhaustiveness) fails
# the CI gate otherwise — so adding a kind forces a decision about who
# reacts to it.  All kinds additionally reach tenants via
# ``Runtime.poll_events`` and the bounded ``RunReport.events`` block.
EVENT_DISPOSITIONS = {
    EventKind.KERNEL_ERROR:
        "reserved (paper §5.2 fault channel); no kernel-fault model "
        "emits it yet — pinned in analysis_baseline.json",
    EventKind.CYCLE_BUDGET_EXCEEDED:
        "telemetry: `killed` counter; report: per-tenant killed count "
        "(watchdog clamp, engine_base.BudgetLedger.kill_kind)",
    EventKind.TOTAL_BUDGET_EXCEEDED:
        "telemetry: `killed` counter; billing exhaustion is permanent "
        "(BudgetLedger.over_total gates later admissions)",
    EventKind.MEMORY_FAULT:
        "telemetry: `killed` counter; serving KV-quota violation path "
        "(serving/engine._kill_request callers)",
    EventKind.QUEUE_OVERFLOW:
        "telemetry: `drops` counter -> signals.drop_rate -> QoS "
        "controller admission pressure",
    EventKind.ECN_MARK:
        "telemetry: `ecn_marks` counter -> signals.ecn_rate -> QoS "
        "controller admission pressure",
    EventKind.BACKPRESSURE:
        "tenant-facing pause notification (controller hysteresis gate); "
        "drained via poll_events before the next submit",
    EventKind.REQUEST_KILLED:
        "telemetry: `killed` counter; serving kill/evict default kind",
    EventKind.ADMITTED:
        "tenant-facing ECTX-creation ack (engine_base.register_tenant)",
    EventKind.EVICTED:
        "tenant-facing ECTX teardown notice; controller.reset_tenant "
        "clears AIMD state on the same boundary",
    EventKind.SLO_ALERT:
        "burn-rate SLO alert (telemetry/slo_audit.py): consumed by the "
        "metrics bus / dashboard, the trace plane (alert->intervention "
        "causality) and RunReport.extras['slo_audit']",
    EventKind.MIGRATE_START:
        "fleet plane (fleet/engine.py): global QoS began live-migrating "
        "the tenant — source FMQ drained, queue state in flight; paired "
        "with MIGRATE_DONE in RunReport.extras['fleet']['migrations']",
    EventKind.MIGRATE_DONE:
        "fleet plane (fleet/engine.py): drained queue replayed through "
        "the fabric onto the destination NIC; tenant re-homed in "
        "extras['fleet']['placement_final']",
    EventKind.SWITCH_DROP:
        "fabric VOQ overflow (fleet/switch.py): counted per tenant in "
        "extras['fleet']['switch'] and the switch conservation law "
        "(injected == delivered + dropped + inflight)",
}


@dataclasses.dataclass(frozen=True)
class Event:
    tenant: int
    kind: EventKind
    time: float
    detail: str = ""


class EventQueue:
    def __init__(self, capacity: int = 4096) -> None:
        self._q: Deque[Event] = deque(maxlen=capacity)
        self.dropped = 0

    def push(self, ev: Event) -> None:
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(ev)

    def poll(self) -> Optional[Event]:
        return self._q.popleft() if self._q else None

    def drain(self) -> List[Event]:
        out = list(self._q)
        self._q.clear()
        return out

    def snapshot(self) -> List[Event]:
        """Non-destructive view of the queued events (reports use this
        so ``poll``/``drain`` still deliver them to the tenant)."""
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)
