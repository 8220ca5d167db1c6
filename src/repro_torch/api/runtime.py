"""The serving runtime adapter (``ServeRuntime``), the request
synthesis (``build_requests``) and the packet-trace synthesis
(``build_traces``) of the OSMOSIS runtime API.

``ServeRuntime`` drives the multi-tenant serving ``Engine`` through the
tenant-facing lifecycle: ``create_tenant``/``destroy_tenant`` (ECTX +
SLOPolicy), ``inject`` (workload), ``run_until`` (clock), ``poll_events``
(EQ), and ``report()`` — a JSON-portable ``RunReport``.  ``run(spec)``
drives a whole declarative ``ScenarioSpec`` end to end.  The clock is
engine steps; work items are ``Request``s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api.report import RunReport, TenantReport, TIME_UNITS, _jsonify
from repro_torch.api.spec import ScenarioSpec
from repro_torch.core.events import Event
from repro_torch.core.slo import ECTX, SLOPolicy

MAX_REPORT_EVENTS = 512   # EQ events embedded per report; rest summarized

# the serving time domain, from the report schema's single whitelist
# (api/report.py TIME_UNITS) — never restate these as string literals
NS_UNIT, STEPS_UNIT = TIME_UNITS


def _events_block(events: List[Event], extras: dict) -> List[dict]:
    """Serialize EQ events (bounded; the total count is always recorded)."""
    extras["events_total"] = len(events)
    return _jsonify([
        {"tenant": e.tenant, "kind": e.kind.value, "time": float(e.time),
         "detail": e.detail} for e in events[:MAX_REPORT_EVENTS]])


def build_traces(spec: ScenarioSpec, *, arrays: bool = False):
    """Materialize the per-tenant packet traces a spec describes.

    ``arrays=True`` returns the ``TraceArrays`` column bundle instead of
    ``TracePacket`` objects — identical packet sequence, no per-packet
    Python objects (the sweep datapath consumes it directly)."""
    from repro_torch.sim.traffic import make_trace_arrays, merge_trace_arrays
    traces = []
    for i, t in enumerate(spec.tenants):
        a = t.arrival
        traces.append(make_trace_arrays(
            i, size=a.size, share=a.share, seed=spec.seed + a.seed_offset,
            duration_ns=a.duration_frac * spec.duration_us * 1e3))
    merged = merge_trace_arrays(*traces)
    return merged if arrays else merged.to_packets()


class ServeRuntime:
    """Runtime adapter over the multi-tenant serving engine."""

    backend = "serve"
    time_unit = STEPS_UNIT

    def __init__(self, ecfg=None, executor=None, **cfg_overrides):
        """``executor`` is either an executor instance or a factory
        ``(EngineConfig) -> executor`` — the factory form exists because
        real executors (``ModelExecutor``) need the very EngineConfig
        this constructor derives (None = scheduling-only NullExecutor)."""
        from repro_torch.serving.engine import Engine, EngineConfig
        if ecfg is None:
            ecfg = EngineConfig(**cfg_overrides)
        elif cfg_overrides:
            ecfg = dataclasses.replace(ecfg, **cfg_overrides)
        self.ecfg = ecfg
        if callable(executor) and not hasattr(executor, "decode"):
            executor = executor(ecfg)
        self.engine = Engine(ecfg, executor=executor)
        self._names: Dict[int, str] = {}
        self._events: List[Event] = []

    @classmethod
    def from_spec(cls, spec: ScenarioSpec, executor=None,
                  **cfg_overrides) -> "ServeRuntime":
        s = spec.serve
        kw = dict(max_slots=s.max_slots, max_len=s.max_len,
                  prefill_chunk=s.prefill_chunk,
                  prefill_slots_per_step=s.prefill_slots_per_step,
                  kv_overcommit=s.kv_overcommit,
                  scheduler=spec.scheduler, arbiter=spec.arbiter,
                  max_tenants=max(len(spec.tenants), 2),
                  qos_interval=(spec.controller.interval_steps
                                if spec.controller else 0))
        kw.update(cfg_overrides)
        return cls(executor=executor, **kw)

    # -- lifecycle ----------------------------------------------------------
    def create_tenant(self, tenant_id: int, slo: SLOPolicy, *,
                      name: str = "", workload=None) -> ECTX:
        e = self.engine.create_ectx(tenant_id, slo, name=name)
        self._names[tenant_id] = e.name
        return e

    def destroy_tenant(self, tenant_id: int) -> List[Event]:
        evs = self.engine.destroy_ectx(tenant_id)
        self._events.extend(evs)
        return evs

    def attach_controller(self, controller) -> None:
        self.engine.attach_controller(controller)

    def attach_bus(self, bus) -> None:
        self.engine.attach_bus(bus)

    def attach_slo_audit(self, audit) -> None:
        self.engine.attach_slo_audit(audit)

    # -- clock + work -------------------------------------------------------
    def inject(self, work: Sequence) -> None:
        for req in work:
            self.engine.submit(req)

    def run_until(self, t: Optional[float] = None) -> float:
        if t is None:
            self.engine.run_until_idle()
        else:
            while self.engine.step_count < t:
                self.engine.step()
        return float(self.engine.step_count)

    def now(self) -> float:
        return float(self.engine.step_count)

    def poll_events(self, tenant_id: int) -> List[Event]:
        mine = [e for e in self._events if e.tenant == tenant_id]
        self._events = [e for e in self._events if e.tenant != tenant_id]
        if tenant_id in self.engine.eq:
            mine.extend(self.engine.poll_events(tenant_id))
        return mine

    # -- scenario runner ----------------------------------------------------
    def run(self, spec: ScenarioSpec) -> RunReport:
        if spec.controller is not None:
            self.attach_controller(spec.controller)    # not ported: raises
        if spec.audit is not None and spec.audit.enabled:
            self.attach_slo_audit(spec.audit)          # not ported: raises
        quota_default = spec.serve.max_len * max(
            1, spec.serve.max_slots // max(len(spec.tenants), 1))
        for i, t in enumerate(spec.tenants):
            slo = t.slo()
            if slo.kv_quota_tokens == 0:
                slo = dataclasses.replace(slo, kv_quota_tokens=quota_default)
            self.create_tenant(i, slo, name=t.name)
        self.inject(build_requests(spec))
        if spec.serve.steps > 0:
            self.run_until(spec.serve.steps)
        else:
            self.run_until(None)
        return self.report(spec)

    # -- report -------------------------------------------------------------
    def report(self, spec: Optional[ScenarioSpec] = None) -> RunReport:
        eng = self.engine
        m = eng.metrics()
        steps = max(eng.step_count, 1)
        tel = eng.tel
        if tel is not None:
            tel.commit()
            snap = tel.snapshot()
            from repro_torch.telemetry.metrics import C_IDX, hist_quantile
            p50 = hist_quantile(snap["hist"], 0.50, np)
            p99 = hist_quantile(snap["hist"], 0.99, np)
        # non-destructive: poll_events still delivers these to the tenant
        # afterwards
        pending = list(self._events)
        for t in sorted(eng.eq):
            pending.extend(eng.eq[t].snapshot())
        tenant_ids = sorted(set(self._names) | set(m["tenants"]))
        tenants: Dict[int, TenantReport] = {}
        for t in tenant_ids:
            d = m["tenants"].get(
                t, {"done": 0, "killed": 0, "mean_fct": 0.0, "tokens": 0})
            if tel is not None:
                counts = snap["counts"][t]
                row = dict(
                    arrivals=int(counts[C_IDX["arrivals"]]),
                    rejected=int(counts[C_IDX["rejected"]]),
                    ecn_marks=int(counts[C_IDX["ecn_marks"]]),
                    drops=int(counts[C_IDX["drops"]]),
                    bytes_in=float(counts[C_IDX["bytes_in"]]),
                    bytes_out=float(counts[C_IDX["bytes_out"]]),
                    throughput=float(counts[C_IDX["tokens"]]) / steps,
                    p50_latency=float(p50[t]), p99_latency=float(p99[t]),
                    latency_samples=int(snap["hist"][t].sum()))
            else:
                row = dict(arrivals=int(d["done"] + d["killed"]),
                           rejected=0, ecn_marks=0, drops=0,
                           bytes_in=0.0, bytes_out=0.0,
                           throughput=float(d["tokens"]) / steps,
                           p50_latency=0.0, p99_latency=0.0,
                           latency_samples=0)
            tenants[t] = TenantReport(
                tenant_id=t, name=self._names.get(t, f"tenant{t}"),
                completed=int(d["done"]), killed=int(d["killed"]),
                extra=_jsonify({"mean_fct": float(d["mean_fct"]),
                                "tokens": float(d["tokens"])}),
                **row)
        extras = {"decode_steps": m["decode_steps"],
                  "prefill_chunks": m["prefill_chunks"]}
        events = _events_block(pending, extras)
        return RunReport(
            scenario=spec.name if spec else "",
            backend="serve", time_unit=STEPS_UNIT,
            duration=float(eng.step_count),
            scheduler=self.ecfg.scheduler, arbiter=self.ecfg.arbiter,
            seed=int(spec.seed) if spec else 0,
            jain_pu=float(m["jain_timeavg"]), jain_io=1.0,
            tenants=tenants, events=events,
            telemetry=(_jsonify(eng.telemetry_report())
                       if tel is not None else None),
            spec=_jsonify(spec.to_dict()) if spec else None,
            extras=_jsonify(extras))


def build_requests(spec: ScenarioSpec):
    """Materialize the request stream a spec's serving projection
    describes: round-robin across tenants, one shared RNG."""
    from repro_torch.serving.request import Request
    rng = np.random.RandomState(spec.seed)
    vocab = spec.serve.vocab
    out = []
    rounds = max((t.arrival.requests for t in spec.tenants), default=0)
    for j in range(rounds):
        for i, t in enumerate(spec.tenants):
            if j >= t.arrival.requests:
                continue
            a = t.arrival
            out.append(Request(
                i, rng.randint(1, vocab, size=a.prompt_len).astype(np.int32),
                max_new_tokens=a.max_new_tokens))
    return out
