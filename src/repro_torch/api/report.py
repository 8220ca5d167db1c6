"""Portable run reports — the one result schema both backends emit.

``RunReport`` replaces the old ``SimResult``-vs-``Engine.metrics()``
divergence at the API boundary: every field is a plain JSON type, the
per-tenant block has the same keys on both backends (backend-specific
detail goes under ``TenantReport.extra``), and ``from_json(to_json(r))
== r`` holds exactly — reports can be archived, diffed, and compared
across backends and commits.

Units differ by backend and are declared, not implied: ``time_unit`` is
``"ns"`` on the simulator and ``"steps"`` on the serving engine;
``throughput`` is Gbit/s of served payload on the simulator and
tokens/step on the engine.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

# the only report time domains: virtual ns (sim), engine steps (serve).
# Single source of truth — runtime.py declares its per-backend unit from
# this tuple.
TIME_UNITS = ("ns", "steps")

# keys every per-tenant block must carry, on either backend
TENANT_FIELDS = ("tenant_id", "name", "arrivals", "completed", "killed",
                 "drops", "rejected", "ecn_marks", "bytes_in", "bytes_out",
                 "throughput", "p50_latency", "p99_latency",
                 "latency_samples", "extra")


def _jsonify(obj: Any) -> Any:
    """Coerce to the exact value a JSON round-trip would produce: numpy
    scalars/arrays -> python numbers/lists, dict keys -> str."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, bool):
        return obj
    if hasattr(obj, "item"):          # numpy scalar
        return obj.item()
    if hasattr(obj, "tolist"):        # numpy array
        return _jsonify(obj.tolist())
    return obj


@dataclasses.dataclass
class TenantReport:
    tenant_id: int
    name: str
    arrivals: int = 0
    completed: int = 0
    killed: int = 0
    drops: int = 0
    rejected: int = 0
    ecn_marks: int = 0
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    throughput: float = 0.0          # sim: Gbit/s; serve: tokens/step
    p50_latency: float = 0.0         # sojourn, in ``time_unit``
    p99_latency: float = 0.0
    latency_samples: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunReport:
    scenario: str
    backend: str                     # "sim" | "serve"
    time_unit: str                   # "ns" | "steps"
    duration: float                  # virtual ns (sim) / steps (serve)
    scheduler: str
    arbiter: str
    seed: int
    jain_pu: float                   # PU/slot fairness (time-averaged)
    jain_io: float                   # IO fairness (sim; 1.0 on serve)
    tenants: Dict[int, TenantReport] = dataclasses.field(default_factory=dict)
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    telemetry: Optional[Dict[str, Any]] = None
    spec: Optional[Dict[str, Any]] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    # -- serde --------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return _jsonify(dataclasses.asdict(self))

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunReport":
        d = dict(d)
        d["tenants"] = {int(t): TenantReport(**r)
                        for t, r in d.get("tenants", {}).items()}
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RunReport":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    # -- schema check -------------------------------------------------------
    def validate(self) -> "RunReport":
        """Raise ``ValueError`` on any schema violation; returns self so
        callers can chain ``report.validate().save(path)``."""
        if self.schema_version != SCHEMA_VERSION:
            raise ValueError(f"schema_version {self.schema_version} != "
                             f"{SCHEMA_VERSION}")
        if self.backend not in ("sim", "serve"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.time_unit not in TIME_UNITS:
            raise ValueError(f"unknown time_unit {self.time_unit!r}")
        for field in ("duration", "jain_pu", "jain_io"):
            v = getattr(self, field)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(f"{field} must be a number, got {v!r}")
        if not (0.0 <= self.jain_pu <= 1.0 + 1e-9):
            raise ValueError(f"jain_pu {self.jain_pu} outside [0, 1]")
        for t, r in self.tenants.items():
            if not isinstance(t, int):
                raise ValueError(f"tenant key {t!r} must be int")
            rd = dataclasses.asdict(r) if isinstance(r, TenantReport) else r
            missing = [k for k in TENANT_FIELDS if k not in rd]
            if missing:
                raise ValueError(f"tenant {t} missing fields {missing}")
            if rd["tenant_id"] != t:
                raise ValueError(f"tenant {t} key/id mismatch "
                                 f"{rd['tenant_id']}")
        for ev in self.events:
            for k in ("tenant", "kind", "time"):
                if k not in ev:
                    raise ValueError(f"event missing {k!r}: {ev}")
        # the whole report must survive a JSON round-trip unchanged
        if RunReport.from_json(self.to_json()) != self:
            raise ValueError("report does not round-trip through JSON")
        self._validate_extras()
        return self

    def _validate_extras(self) -> None:
        """Known ``extras`` blocks carry their declared schemas: the
        key tuples live next to the producers (single source of truth)
        so the check can never drift from what they emit."""
        sa = self.extras.get("slo_audit")
        if sa is not None:
            from repro_torch.telemetry.slo_audit import (SUMMARY_KEYS,
                                                         TENANT_SUMMARY_KEYS)
            missing = [k for k in SUMMARY_KEYS if k not in sa]
            if missing:
                raise ValueError(f"slo_audit missing keys {missing}")
            if sa["interval_unit"] != self.time_unit:
                raise ValueError(
                    f"slo_audit interval_unit {sa['interval_unit']!r} != "
                    f"report time_unit {self.time_unit!r}")
            for t, row in sa["tenants"].items():
                tmiss = [k for k in TENANT_SUMMARY_KEYS if k not in row]
                if tmiss:
                    raise ValueError(
                        f"slo_audit tenant {t} missing keys {tmiss}")
        ts = self.extras.get("trace_summary")
        if ts is not None:
            from repro_torch.telemetry.trace import TraceRecorder
            missing = [k for k in TraceRecorder.TRACE_SUMMARY_KEYS
                       if k not in ts]
            if missing:
                raise ValueError(f"trace_summary missing keys {missing}")
        fl = self.extras.get("fleet")
        if fl is not None:
            from repro_torch.fleet.engine import FLEET_EXTRAS_KEYS
            missing = [k for k in FLEET_EXTRAS_KEYS if k not in fl]
            if missing:
                raise ValueError(f"fleet extras missing keys {missing}")
            if len(fl["per_nic"]) != fl["num_nics"]:
                raise ValueError(
                    f"fleet per_nic has {len(fl['per_nic'])} reports "
                    f"for {fl['num_nics']} NICs")

    # -- console ------------------------------------------------------------
    def summary(self) -> str:
        unit = self.time_unit
        tput_unit = "Gbit/s" if self.backend == "sim" else "tok/step"
        lines = [f"scenario={self.scenario} backend={self.backend} "
                 f"policy={self.scheduler}+{self.arbiter} "
                 f"duration={self.duration:g}{unit} "
                 f"jain_pu={self.jain_pu:.3f} jain_io={self.jain_io:.3f}",
                 f" {'tenant':<18}{'done':>6}{'kill':>6}{'drop':>6}"
                 f"{'p50':>10}{'p99':>10}  tput({tput_unit})"]
        for t in sorted(self.tenants):
            r = self.tenants[t]
            lines.append(
                f" {r.name[:17]:<18}{r.completed:>6}{r.killed:>6}"
                f"{r.drops:>6}{r.p50_latency:>10.4g}{r.p99_latency:>10.4g}"
                f"  {r.throughput:.4g}")
        return "\n".join(lines)
