"""Per-tenant telemetry plane + closed-loop QoS control.

``metrics``    — fixed-shape array-native collectors (counters, log
                 histograms, gauge rings), numpy backend.
``signals``    — derived congestion/SLO signals read by the control plane.
``controller`` — AIMD weight adaptation + hysteretic admission gate.
``report``     — per-tenant JSON/console reports.
``slo_audit``  — per-tenant error budgets + burn-rate SLO alerts.

The trace plane, the metrics bus and its exporters are not ported yet.
"""
from repro_torch.telemetry.metrics import (COUNTERS, GAUGES, C_IDX, G_IDX,
                                           HIST_BUCKETS, RING_WINDOW,
                                           Telemetry, bucket_index,
                                           bucket_value, create_state,
                                           hist_add, hist_quantile,
                                           record_step, record_window,
                                           ring_mean, ring_push)
from repro_torch.telemetry.signals import (SignalFrame, compute_signals,
                                           wlbvt_service_debt)
from repro_torch.telemetry.controller import (ControlAction, QoSConfig,
                                              QoSController,
                                              apply_to_scheduler)
from repro_torch.telemetry.report import (dump_json, format_console,
                                          tenant_report)
from repro_torch.telemetry.slo_audit import (SLOAlert, SLOAudit,
                                             SLOAuditConfig)

__all__ = [
    "COUNTERS", "GAUGES", "C_IDX", "G_IDX", "HIST_BUCKETS", "RING_WINDOW",
    "Telemetry", "bucket_index", "bucket_value", "create_state", "hist_add",
    "hist_quantile", "record_step", "record_window", "ring_mean", "ring_push",
    "SignalFrame", "compute_signals", "wlbvt_service_debt",
    "ControlAction", "QoSConfig", "QoSController", "apply_to_scheduler",
    "dump_json", "format_console", "tenant_report",
    "SLOAlert", "SLOAudit", "SLOAuditConfig",
]
