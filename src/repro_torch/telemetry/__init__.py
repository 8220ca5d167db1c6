"""Per-tenant telemetry plane.

``metrics`` — fixed-shape array-native collectors (counters, log
              histograms, gauge rings), numpy backend.
``report``  — per-tenant JSON/console reports.
"""
from repro_torch.telemetry.metrics import (COUNTERS, GAUGES, C_IDX, G_IDX,
                                           HIST_BUCKETS, RING_WINDOW,
                                           Telemetry, bucket_index,
                                           bucket_value, create_state,
                                           hist_add, hist_quantile,
                                           record_step, record_window,
                                           ring_mean, ring_push)
from repro_torch.telemetry.report import (dump_json, format_console,
                                          tenant_report)

__all__ = [
    "COUNTERS", "GAUGES", "C_IDX", "G_IDX", "HIST_BUCKETS", "RING_WINDOW",
    "Telemetry", "bucket_index", "bucket_value", "create_state", "hist_add",
    "hist_quantile", "record_step", "record_window", "ring_mean", "ring_push",
    "dump_json", "format_console", "tenant_report",
]
