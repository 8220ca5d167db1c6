"""Declarative scenario specifications — the tenant-facing half of the
unified OSMOSIS runtime API (DESIGN.md §7).

A ``ScenarioSpec`` is pure data: who the tenants are (SLO knobs, cost
model, arrival process), which mechanisms are enabled (scheduler,
arbiter, fragmentation, QoS controller), and how long to run.  The same
spec drives every execution surface: the simulators (``SimRuntime`` in
``api/runtime.py``, and the sweep datapath ``sim/devicepath.py``)
materialize a packet trace from each tenant's ``ArrivalSpec``
(``build_traces``) and a cost model from its ``WorkloadSpec``; the
serving engine (``ServeRuntime``) materializes a request stream from its
serving projection fields.  A spec serializes exactly as the JAX
package's does.

Specs are frozen dataclasses of plain scalars/tuples, so they are
hashable, JSON round-trippable (``to_dict``/``from_dict``) and cheap to
derive variants from (``replace``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.fragmentation import FragmentationPolicy
from repro_torch.core.slo import SLOPolicy


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A kernel cost model: a named entry in ``sim.workloads.WORKLOADS``
    (``ref``) or inline ``WorkloadModel`` parameters.  Serving runs
    ignore the cost model (the model *is* the cost)."""
    ref: str = ""                    # WORKLOADS name; overrides the rest
    name: str = ""                   # label for an inline model
    compute_base: float = 50.0       # handler entry/exit cycles
    compute_per_byte: float = 0.0    # PU cycles per payload byte
    io_kind: str = "none"            # none | dma_read | dma_write | egress
    io_bytes_factor: float = 1.0
    io_fixed_bytes: int = 0
    spin_factor: float = 1.0         # synthetic congestor multiplier

    def build(self):
        """Materialize the simulator's ``WorkloadModel``."""
        from repro_torch.sim.workloads import WORKLOADS, WorkloadModel
        if self.ref:
            return WORKLOADS[self.ref]
        return WorkloadModel(self.name or "custom", self.compute_base,
                             self.compute_per_byte, io_kind=self.io_kind,
                             io_bytes_factor=self.io_bytes_factor,
                             io_fixed_bytes=self.io_fixed_bytes,
                             spin_factor=self.spin_factor)


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Per-tenant workload arrival process.

    Sim fields map onto ``sim.traffic.make_trace``; the serving
    projection fields describe the equivalent request stream (one
    request = one "packet", DESIGN.md §2).
    """
    size: int = 512                  # packet bytes incl. header (sim)
    share: float = 0.5               # fraction of the ingress link (sim)
    duration_frac: float = 1.0       # fraction of the scenario duration
    seed_offset: int = 0             # added to the scenario seed
    # serving projection:
    requests: int = 16               # total requests injected
    prompt_len: int = 16             # tokens per prompt
    max_new_tokens: int = 16         # generation budget per request


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: identity + SLO knobs + cost model + arrival."""
    name: str
    workload: WorkloadSpec = WorkloadSpec()
    arrival: ArrivalSpec = ArrivalSpec()
    priority: float = 1.0
    dma_priority: float = 1.0
    egress_priority: float = 1.0
    kernel_cycle_limit: int = 0
    total_cycle_limit: int = 0
    kv_quota_tokens: int = 0         # 0 = engine default (one slot)
    p99_target: float = 0.0          # controller latency SLO, in the
    #                                  backend's time unit (0 = none)

    def slo(self) -> SLOPolicy:
        return SLOPolicy(priority=self.priority,
                         dma_priority=self.dma_priority,
                         egress_priority=self.egress_priority,
                         kernel_cycle_limit=self.kernel_cycle_limit,
                         total_cycle_limit=self.total_cycle_limit,
                         kv_quota_tokens=self.kv_quota_tokens)


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Closed-loop QoS controller configuration (DESIGN.md §6).

    Per-tenant p99 sojourn targets come from ``TenantSpec.p99_target``
    scaled by ``target_scale[backend]`` so one spec can carry targets
    for both time units (ns on the simulator, steps on the engine)."""
    interval_ns: float = 8000.0      # sim control interval (virtual ns)
    interval_steps: int = 16         # serving control interval (steps)
    target_scale_sim: float = 1.0
    target_scale_serve: float = 1.0

    def p99_targets(self, tenants: Tuple[TenantSpec, ...], backend: str,
                    num_tenants: int):
        scale = (self.target_scale_sim if backend == "sim"
                 else self.target_scale_serve)
        out = [0.0] * num_tenants
        for i, t in enumerate(tenants):
            out[i] = t.p99_target * scale
        return out


@dataclasses.dataclass(frozen=True)
class AuditSpec:
    """SLO burn-rate audit knobs (telemetry/slo_audit.py, DESIGN.md
    §11.3).  ``None`` on the scenario means *auto*: the audit attaches
    whenever a QoS controller with live p99 targets is configured, so
    every closed-loop run ships an ``extras['slo_audit']`` block."""
    enabled: bool = True
    objective: float = 0.9           # good-interval objective (budget =
    #                                  1 - objective)
    fast_windows: int = 2            # acute window, observation intervals
    slow_windows: int = 8            # sustained window
    fast_burn: float = 5.0           # alert thresholds (burn multiples)
    slow_burn: float = 2.0


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Serving-engine projection knobs (EngineConfig subset)."""
    max_slots: int = 8
    max_len: int = 256
    prefill_chunk: int = 32
    prefill_slots_per_step: int = 2
    kv_overcommit: float = 1.0
    steps: int = 0                   # 0 = run until idle
    vocab: int = 90                  # prompt token range for synthesis


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A complete, declarative multi-tenant scenario."""
    name: str
    description: str = ""
    tenants: Tuple[TenantSpec, ...] = ()
    backends: Tuple[str, ...] = ("sim",)
    scheduler: str = "wlbvt"         # "wlbvt" | "rr"
    arbiter: str = "dwrr"            # "dwrr" | "fifo"
    frag_mode: str = "off"           # "off" | "software" | "hardware"
    frag_bytes: int = 512
    duration_us: float = 150.0       # sim horizon (drains remaining work)
    horizon_us: float = 0.0          # >0: stop the sim clock here instead
    #                                  of draining queued work (fixed
    #                                  measurement window, fig9-style)
    fifo_capacity: int = 4096
    io_demand_weights: str = "uniform"   # "uniform" | "demand"
    record_timeline: bool = False
    controller: Optional[ControllerSpec] = None
    audit: Optional[AuditSpec] = None    # None = auto (see AuditSpec)
    seed: int = 0
    serve: ServeSpec = ServeSpec()
    analytic: str = ""               # "" | "ppb": computed, not simulated
    datapath: str = "event"          # sim backend: "event" | "batched"
    #                                  (same decisions — DESIGN.md §8)

    def replace(self, **kw) -> "ScenarioSpec":
        return dataclasses.replace(self, **kw)

    def frag(self) -> FragmentationPolicy:
        if self.frag_mode == "off":
            return FragmentationPolicy(mode="off")
        return FragmentationPolicy(mode=self.frag_mode,
                                   fragment_bytes=self.frag_bytes)

    # -- serde --------------------------------------------------------------
    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ScenarioSpec":
        d = dict(d)
        d["tenants"] = tuple(
            TenantSpec(**{**t,
                          "workload": WorkloadSpec(**t["workload"]),
                          "arrival": ArrivalSpec(**t["arrival"])})
            for t in d.get("tenants", ()))
        d["backends"] = tuple(d.get("backends", ("sim",)))
        if d.get("controller") is not None:
            d["controller"] = ControllerSpec(**d["controller"])
        if d.get("audit") is not None:
            d["audit"] = AuditSpec(**d["audit"])
        if "serve" in d:
            d["serve"] = ServeSpec(**d["serve"])
        return cls(**d)
