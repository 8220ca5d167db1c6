"""Per-tenant telemetry plane + closed-loop QoS control.

``metrics``    — fixed-shape array-native collectors (counters, log
                 histograms, gauge rings); one kernel set for numpy (the
                 simulators, eager fp64) and its ``*_torch`` counterparts
                 for the ``"torch"`` backend (state on a device, commits
                 with no host sync).
``signals``    — derived congestion/SLO signals read by the control plane.
``controller`` — AIMD weight adaptation + hysteretic admission gate.
``report``     — per-tenant JSON/console reports.
``trace``      — packet-lifecycle flight recorder + decision provenance.
``traceview``  — Perfetto export and the console waterfall.
``bus``        — streaming metrics bus (bounded drop-oldest fan-out).
``export``     — OpenMetrics / JSONL exporters over the bus.
``slo_audit``  — per-tenant error budgets + burn-rate SLO alerts.
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
from repro_torch.telemetry.trace import (DECISION_KINDS, DISPOSITIONS,
                                         REASONS, STAGES, TraceRecorder,
                                         ring_scatter, record_slo_alert,
                                         record_qos_intervention)
from repro_torch.telemetry.traceview import (console_waterfall, to_perfetto,
                                             write_perfetto)
from repro_torch.telemetry.bus import BusFrame, MetricsBus, Subscription
from repro_torch.telemetry.export import (METRICS, MetricSpec, JsonlExporter,
                                          OpenMetricsWriter,
                                          attach_exporters, schema_lines)
from repro_torch.telemetry.slo_audit import (SLOAlert, SLOAudit,
                                             SLOAuditConfig)

__all__ = [
    "COUNTERS", "GAUGES", "C_IDX", "G_IDX", "HIST_BUCKETS", "RING_WINDOW",
    "Telemetry", "bucket_index", "bucket_value", "create_state", "hist_add",
    "hist_quantile", "record_step", "record_window", "ring_mean", "ring_push",
    "SignalFrame", "compute_signals", "wlbvt_service_debt",
    "ControlAction", "QoSConfig", "QoSController", "apply_to_scheduler",
    "dump_json", "format_console", "tenant_report",
    "DECISION_KINDS", "DISPOSITIONS", "REASONS", "STAGES",
    "TraceRecorder", "ring_scatter",
    "console_waterfall", "to_perfetto", "write_perfetto",
    "record_slo_alert", "record_qos_intervention",
    "BusFrame", "MetricsBus", "Subscription",
    "METRICS", "MetricSpec", "JsonlExporter", "OpenMetricsWriter",
    "attach_exporters", "schema_lines",
    "SLOAlert", "SLOAudit", "SLOAuditConfig",
]
