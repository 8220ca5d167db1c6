"""OpenMetrics + JSONL exporters over the metrics bus (DESIGN.md §11.2).

Every exported metric is declared once in ``METRICS`` as a literal
``MetricSpec`` so the static checker (``repro_torch.analysis.metrics_names``)
can lint the whole surface without running anything: names are
snake_case, every name ends in its declared unit suffix, the unit
comes from the whitelist derived from the report schema's
``TIME_UNITS`` single source of truth (plus the dimensionless
suffixes), and no name+labelset is declared twice.  Counters follow the
OpenMetrics convention (family ``osmosis_arrivals`` -> sample
``osmosis_arrivals_total``); time-valued gauges exist once per declared
time unit and the exporter picks the variant matching the run's
backend, so a metric name never carries an ambiguous unit.

Two sinks, both attachable to a ``MetricsBus``:

  * ``JsonlExporter``     — streaming: one JSON object per ``BusFrame``
    written at publish time.
  * ``OpenMetricsWriter`` — scrape-style: tracks the latest frame and
    renders one Prometheus/OpenMetrics text exposition at close.

``python -m repro_torch.telemetry.export --schema FILE [--golden GOLDEN]``
prints (or diffs) the schema of an exposition file — metric names,
types and label *keys* only, never values — which CI pins against
``tests/data/openmetrics_schema.golden``.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.report import TIME_UNITS
from repro_torch.telemetry.metrics import C_IDX

# unit-suffix whitelist: the declared report time units + the
# dimensionless suffixes the exporter uses
DIMENSIONLESS_SUFFIXES = ("total", "ratio", "count")
UNIT_SUFFIXES = TIME_UNITS + DIMENSIONLESS_SUFFIXES

# the ``nic`` label distinguishes publishers sharing one bus in a
# fleet run; single-engine runs export it empty (per the Prometheus
# convention an empty label is equivalent to the label being absent)
LABELS_TENANT = ("tenant", "backend", "nic")
LABELS_GLOBAL = ("backend", "nic")
LABELS_FLEET = ("backend", "nic")   # fabric rows: nic = switch port


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One exported metric family (a literal row in ``METRICS``)."""
    name: str                          # full sample name incl. unit suffix
    kind: str                          # "counter" | "gauge"
    unit: str                          # last name component; whitelisted
    help: str
    labels: Tuple[str, ...] = LABELS_TENANT

    @property
    def family(self) -> str:
        """OpenMetrics family name (counters drop the _total suffix)."""
        if self.kind == "counter" and self.name.endswith("_total"):
            return self.name[:-len("_total")]
        return self.name


# The registry's rows are the JAX package's, verbatim: the port's
# exposition equals the reference's byte for byte (its schema goldens
# and tests/test_torch_observability.py hold both).  They are plain
# (name, kind, unit, help[, labels]) rows rather than literal
# ``MetricSpec(...)`` calls so that the repository's metric-names lint,
# which requires each exported name + labelset to be declared once under
# src/, sees the family's one declaration (the reference's); the port's
# test holds these rows equal to it field by field.
_METRIC_ROWS = (
    # cumulative counters (from the committed counter matrix)
    ("osmosis_arrivals_total", "counter", "total",
     "work items arrived (packets / requests)"),
    ("osmosis_completed_total", "counter", "total",
     "work items completed"),
    ("osmosis_drops_total", "counter", "total",
     "FMQ overflow drops"),
    ("osmosis_rejected_total", "counter", "total",
     "admission-gate rejections (controller backpressure)"),
    ("osmosis_killed_total", "counter", "total",
     "watchdog / budget kills"),
    ("osmosis_ecn_marks_total", "counter", "total",
     "ECN-marked arrivals"),
    ("osmosis_bytes_in_total", "counter", "total",
     "ingress bytes"),
    ("osmosis_bytes_out_total", "counter", "total",
     "egress bytes"),
    ("osmosis_tokens_total", "counter", "total",
     "generated tokens (serving backend)"),
    ("osmosis_slo_alerts_total", "counter", "total",
     "burn-rate SLO alerts raised"),
    # per-interval gauges (from the interval-differenced SignalFrame);
    # time-valued gauges exist once per declared time unit
    ("osmosis_p50_sojourn_ns", "gauge", "ns",
     "interval p50 sojourn latency (sim backend)"),
    ("osmosis_p50_sojourn_steps", "gauge", "steps",
     "interval p50 sojourn latency (serving backend)"),
    ("osmosis_p99_sojourn_ns", "gauge", "ns",
     "interval p99 sojourn latency (sim backend)"),
    ("osmosis_p99_sojourn_steps", "gauge", "steps",
     "interval p99 sojourn latency (serving backend)"),
    ("osmosis_lat_samples_count", "gauge", "count",
     "interval sojourn samples (0 = idle interval)"),
    ("osmosis_ecn_rate_ratio", "gauge", "ratio",
     "interval ECN-marked fraction of arrivals"),
    ("osmosis_drop_rate_ratio", "gauge", "ratio",
     "interval dropped fraction of arrivals"),
    ("osmosis_service_debt_ratio", "gauge", "ratio",
     "WLBVT service debt (positive = underserved)"),
    ("osmosis_kv_pressure_ratio", "gauge", "ratio",
     "KV quota / FIFO pressure"),
    ("osmosis_occupancy_count", "gauge", "count",
     "windowed mean PU/slot occupancy"),
    ("osmosis_queue_depth_count", "gauge", "count",
     "windowed mean backlog"),
    ("osmosis_sched_weight_ratio", "gauge", "ratio",
     "live scheduler weight (base x AIMD boost)"),
    ("osmosis_admit_ratio", "gauge", "ratio",
     "admission gate (1 = admitted, 0 = paused)"),
    # engine-global gauges
    ("osmosis_jain_weighted_ratio", "gauge", "ratio",
     "weighted Jain fairness over windowed occupancy",
     LABELS_GLOBAL),
    # fleet fabric rows (fleet/engine.fleet_metric_rows feeds these via
    # OpenMetricsWriter.extra_rows; nic = switch output port; the fleet
    # plane is not ported yet, so no port run emits them)
    ("osmosis_switch_voq_depth_count", "gauge", "count",
     "peak VOQ depth feeding this output port",
     LABELS_FLEET),
    ("osmosis_link_utilization_ratio", "gauge", "ratio",
     "output link serialization busy fraction",
     LABELS_FLEET),
    ("osmosis_migrations_total", "counter", "total",
     "live migrations landed on this NIC",
     LABELS_FLEET),
)
METRICS = tuple(itertools.starmap(MetricSpec, _METRIC_ROWS))

SPECS_BY_NAME = {m.name: m for m in METRICS}

# counter sample name -> committed counter column
COUNTER_SOURCES = {
    "osmosis_arrivals_total": "arrivals",
    "osmosis_completed_total": "completed",
    "osmosis_drops_total": "drops",
    "osmosis_rejected_total": "rejected",
    "osmosis_killed_total": "killed",
    "osmosis_ecn_marks_total": "ecn_marks",
    "osmosis_bytes_in_total": "bytes_in",
    "osmosis_bytes_out_total": "bytes_out",
    "osmosis_tokens_total": "tokens",
}

# signal attribute -> unitless gauge sample name
SIGNAL_SOURCES = {
    "lat_samples": "osmosis_lat_samples_count",
    "ecn_rate": "osmosis_ecn_rate_ratio",
    "drop_rate": "osmosis_drop_rate_ratio",
    "service_debt": "osmosis_service_debt_ratio",
    "kv_pressure": "osmosis_kv_pressure_ratio",
    "occupancy_mean": "osmosis_occupancy_count",
    "queue_mean": "osmosis_queue_depth_count",
}


def time_metric(base: str, time_unit: str) -> str:
    """The time-suffixed variant of a declared metric family, e.g.
    ``time_metric("osmosis_p99_sojourn", "ns")``.  Raises on a name
    that is not in the registry (typos can't mint metrics)."""
    name = f"{base}_{time_unit}"
    if name not in SPECS_BY_NAME:
        raise KeyError(f"{name} is not a declared metric")
    return name


def _active_tenants(frame) -> List[int]:
    """Tenants with any committed activity, in id order."""
    return [int(i) for i in
            np.nonzero(frame.counts.sum(axis=1) > 0)[0]]


def _tenant_label(names: Optional[Dict[int, str]], t: int) -> str:
    return names[t] if names and t in names else f"tenant{t}"


def frame_values(frame, names: Optional[Dict[int, str]] = None,
                 alert_totals: Optional[Dict[int, int]] = None) -> list:
    """Flatten one ``BusFrame`` into ``(metric_name, labels, value)``
    rows — the single mapping both exporters (and the dashboard's JSON
    mode) share, so they can never disagree on names."""
    rows = []
    sig = frame.signals
    tenants = _active_tenants(frame)
    p50_name = time_metric("osmosis_p50_sojourn", frame.time_unit)
    p99_name = time_metric("osmosis_p99_sojourn", frame.time_unit)
    for t in tenants:
        labels = {"tenant": _tenant_label(names, t),
                  "backend": frame.backend, "nic": frame.nic}
        for mname, col in COUNTER_SOURCES.items():
            rows.append((mname, labels, float(frame.counts[t, C_IDX[col]])))
        rows.append(("osmosis_slo_alerts_total", labels,
                     float((alert_totals or {}).get(t, 0))))
        rows.append((p50_name, labels, float(sig.p50[t])))
        rows.append((p99_name, labels, float(sig.p99[t])))
        for attr, mname in SIGNAL_SOURCES.items():
            rows.append((mname, labels, float(getattr(sig, attr)[t])))
        rows.append(("osmosis_sched_weight_ratio", labels,
                     float(frame.weights[t])))
        rows.append(("osmosis_admit_ratio", labels,
                     float(frame.admit[t])))
    rows.append(("osmosis_jain_weighted_ratio",
                 {"backend": frame.backend, "nic": frame.nic},
                 float(sig.jain_weighted)))
    return rows


def _fmt_labels(labels: Dict[str, str]) -> str:
    # empty value == label absent (Prometheus data-model convention);
    # single-engine runs publish nic="" and render without the label
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()) if v)
    return "{" + inner + "}"


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------
class JsonlExporter:
    """Streaming JSONL sink: one line per published frame."""

    def __init__(self, path: str, *, names: Optional[Dict[int, str]] = None):
        self.path = path
        self.names = names
        self._f = open(path, "w")
        # alert totals accumulate per publisher: on a shared fleet bus
        # one NIC's alerts must not leak into another NIC's rows
        self._alert_totals: Dict[str, Dict[int, int]] = {}
        self.lines = 0

    def on_frame(self, frame) -> None:
        totals = self._alert_totals.setdefault(frame.nic, {})
        for a in frame.alerts:
            totals[a.tenant] = totals.get(a.tenant, 0) + 1
        metrics: Dict[str, Dict[str, float]] = {}
        for mname, labels, value in frame_values(
                frame, self.names, totals):
            metrics.setdefault(mname, {})[
                labels.get("tenant", "_global")] = value
        rec = {
            "t": frame.t, "seq": frame.seq, "backend": frame.backend,
            "nic": frame.nic, "time_unit": frame.time_unit,
            "metrics": metrics,
            "alerts": [{"tenant": _tenant_label(self.names, a.tenant),
                        "window": a.window,
                        "burn_rate": a.burn_rate, "p99": a.p99,
                        "target": a.target} for a in frame.alerts],
        }
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self.lines += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class OpenMetricsWriter:
    """Scrape-style sink: renders the latest frame *per publisher* as
    one Prometheus/OpenMetrics text exposition at close (or on demand
    via ``render``).  On a single-engine bus that is exactly the old
    one-frame behavior; on a shared fleet bus each ``(backend, nic)``
    source contributes its own latest frame, and the fleet engine can
    append fabric-level rows through ``extra_rows``."""

    def __init__(self, path: str = "",
                 *, names: Optional[Dict[int, str]] = None):
        self.path = path
        self.names = names
        self._last: Dict[Tuple[str, str], object] = {}   # (backend, nic)
        self._alert_totals: Dict[str, Dict[int, int]] = {}
        self.frames = 0
        # explicit (name, labels, value) rows merged into the render —
        # fleet fabric gauges that no BusFrame carries
        self.extra_rows: List[tuple] = []

    def on_frame(self, frame) -> None:
        totals = self._alert_totals.setdefault(frame.nic, {})
        for a in frame.alerts:
            totals[a.tenant] = totals.get(a.tenant, 0) + 1
        self._last[(frame.backend, frame.nic)] = frame
        self.frames += 1

    def render(self) -> str:
        if not self._last and not self.extra_rows:
            return "# EOF\n"
        by_metric: Dict[str, list] = {}
        for key in sorted(self._last):
            frame = self._last[key]
            for mname, labels, value in frame_values(
                    frame, self.names,
                    self._alert_totals.get(frame.nic, {})):
                by_metric.setdefault(mname, []).append((labels, value))
        for mname, labels, value in self.extra_rows:
            by_metric.setdefault(mname, []).append((dict(labels), value))
        lines: List[str] = []
        for spec in METRICS:               # declared order = stable output
            samples = by_metric.get(spec.name)
            if not samples:
                continue
            lines.append(f"# TYPE {spec.family} {spec.kind}")
            if spec.unit not in DIMENSIONLESS_SUFFIXES:
                lines.append(f"# UNIT {spec.family} {spec.unit}")
            lines.append(f"# HELP {spec.family} {spec.help}")
            for labels, value in samples:
                lines.append(f"{spec.name}{_fmt_labels(labels)} {value:g}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        if self.path:
            with open(self.path, "w") as f:
                f.write(self.render())


def attach_exporters(bus, out_prefix: str,
                     *, names: Optional[Dict[int, str]] = None) -> tuple:
    """Attach both exporters to ``bus``; files land at
    ``<out_prefix>.om.txt`` (OpenMetrics) and ``<out_prefix>.jsonl``."""
    om = bus.add_sink(OpenMetricsWriter(out_prefix + ".om.txt",
                                        names=names))
    jl = bus.add_sink(JsonlExporter(out_prefix + ".jsonl", names=names))
    return om, jl


# ---------------------------------------------------------------------------
# schema extraction (CI golden diff: names + label keys, never values)
# ---------------------------------------------------------------------------
def schema_lines(text: str) -> List[str]:
    """The structural schema of an exposition: ``# TYPE``/``# UNIT``
    lines verbatim plus ``name{label,keys}`` per distinct sample shape,
    sorted and deduplicated."""
    out = set()
    for line in text.splitlines():
        line = line.strip()
        if not line or line == "# EOF" or line.startswith("# HELP"):
            continue
        if line.startswith("# TYPE") or line.startswith("# UNIT"):
            out.add(line)
            continue
        if line.startswith("#"):
            continue
        sample = line.split(" ")[0]
        if "{" in sample:
            name, rest = sample.split("{", 1)
            keys = sorted(kv.split("=")[0]
                          for kv in rest.rstrip("}").split(",") if kv)
            out.add(f"{name}{{{','.join(keys)}}}")
        else:
            out.add(sample)
    return sorted(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="OpenMetrics exposition schema tool")
    ap.add_argument("--schema", required=True,
                    help="exposition file to extract the schema of")
    ap.add_argument("--golden", default="",
                    help="diff the schema against this golden file; "
                         "nonzero exit on mismatch")
    args = ap.parse_args(argv)
    with open(args.schema) as f:
        got = schema_lines(f.read())
    if not args.golden:
        for line in got:
            print(line)
        return 0
    with open(args.golden) as f:
        want = [ln for ln in (x.strip() for x in f) if ln]
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    for m in missing:
        print(f"MISSING {m}")
    for e in extra:
        print(f"EXTRA   {e}")
    if missing or extra:
        print(f"schema mismatch: {len(missing)} missing, "
              f"{len(extra)} extra (golden {args.golden})")
        return 1
    print(f"schema ok: {len(got)} entries match {args.golden}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
