"""Per-tenant telemetry reports: JSON-able dicts + console rendering."""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.telemetry import metrics as M
from repro_torch.telemetry.signals import SignalFrame


def tenant_report(tel, *, names: Optional[Dict[int, str]] = None,
                  signals: Optional[SignalFrame] = None,
                  only_active: bool = True) -> dict:
    """Fold a ``Telemetry`` plane (and optionally a ``SignalFrame``) into
    a JSON-able per-tenant report."""
    snap = tel.snapshot()
    counts, hist = snap["counts"], snap["hist"]
    p50 = M.hist_quantile(hist, 0.50, np)
    p99 = M.hist_quantile(hist, 0.99, np)
    seen = counts.sum(axis=1) + hist.sum(axis=1)
    tenants = {}
    for t in range(tel.T):
        if only_active and seen[t] == 0:
            continue
        row = {n: float(counts[t, i]) for n, i in M.C_IDX.items()}
        row["p50_latency"] = float(p50[t])
        row["p99_latency"] = float(p99[t])
        row["latency_samples"] = float(hist[t].sum())
        if names and t in names:
            row["name"] = names[t]
        if signals is not None:
            row["service_debt"] = float(signals.service_debt[t])
            row["ecn_rate"] = float(signals.ecn_rate[t])
            row["kv_pressure"] = float(signals.kv_pressure[t])
        tenants[t] = row
    out = {"num_tenants": tel.T, "backend": tel.backend, "tenants": tenants}
    if signals is not None:
        out["jain_weighted"] = signals.jain_weighted
    return out


# columns holding times in the report's declared latency unit
TIME_COLS = ("p50_latency", "p99_latency")


def _latency_unit(report: dict, time_unit: Optional[str]) -> str:
    # lazy import: api.report pulls telemetry for trace summaries
    from repro_torch.api.report import TIME_UNITS
    unit = time_unit or report.get("latency_unit") or TIME_UNITS[0]
    if unit not in TIME_UNITS:
        raise ValueError(f"latency unit {unit!r} is not one of the "
                         f"declared TIME_UNITS {TIME_UNITS}")
    return unit


def format_console(report: dict, *,
                   time_unit: Optional[str] = None) -> str:
    """Console table; time columns carry the declared unit
    (``api.report.TIME_UNITS``) in their header, never bare numbers."""
    unit = _latency_unit(report, time_unit)
    cols = ["arrivals", "completed", "killed", "drops", "ecn_marks",
            "p50_latency", "p99_latency"]
    heads = [f"{c[:3]}({unit})" if c in TIME_COLS else c for c in cols]
    lines = [" tenant  " + "  ".join(f"{h:>12}" for h in heads)]
    for t, row in sorted(report["tenants"].items()):
        label = row.get("name", f"tenant{t}")[:8]
        vals = "  ".join(f"{row[c]:>12.6g}" for c in cols)
        lines.append(f" {label:<8}" + vals)
    if "jain_weighted" in report:
        lines.append(f" weighted Jain fairness: "
                     f"{report['jain_weighted']:.4f}")
    return "\n".join(lines)


def dump_json(report: dict, path: str, *,
              overwrite: bool = False) -> None:
    """Write the report as JSON; refuses to clobber an existing file
    unless ``overwrite=True``."""
    if not overwrite and os.path.exists(path):
        raise FileExistsError(
            f"{path} exists; pass overwrite=True to replace it")
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
