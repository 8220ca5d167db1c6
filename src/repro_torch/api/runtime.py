"""The unified OSMOSIS runtime protocol + backend adapters (DESIGN.md §7).

One tenant-facing control-plane surface over both execution substrates:

  * ``SimRuntime``   — wraps the cycle-level PsPIN ``Simulator`` (or its
    batched datapath); the clock is virtual nanoseconds, work items are
    ``TracePacket``s.
  * ``ServeRuntime`` — wraps the multi-tenant serving ``Engine``; the
    clock is engine steps, work items are ``Request``s.

Both expose the same lifecycle: ``create_tenant``/``destroy_tenant``
(ECTX + SLOPolicy), ``inject`` (workload), ``attach_controller`` (QoS),
``run_until`` (clock), ``poll_events`` (EQ), and ``report()`` — a
schema-identical, JSON-portable ``RunReport`` (byte for byte the JAX
package's on the same spec).  ``run(spec)`` drives a whole declarative
``ScenarioSpec`` end to end; ``run_scenario`` is the one-call entry point.
Both runtimes take the observability planes: ``attach_bus`` (one
``BusFrame`` per observation interval), ``trace=True`` (the flight
recorder; ``flush_trace`` and ``extras["trace_summary"]``) and the SLO
audit.  A ``FleetSpec`` goes to the fleet plane (``fleet/engine.py``):
N per-NIC ``SimRuntime``s over the modeled switch, one aggregated
report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.api.report import RunReport, TenantReport, TIME_UNITS, _jsonify
from repro_torch.api.spec import ScenarioSpec
from repro_torch.core.events import Event
from repro_torch.core.slo import ECTX, SLOPolicy

MAX_REPORT_EVENTS = 512   # EQ events embedded per report; rest summarized

# per-backend time domains, from the report schema's single whitelist
# (api/report.py TIME_UNITS) — never restate these as string literals
NS_UNIT, STEPS_UNIT = TIME_UNITS


@runtime_checkable
class Runtime(Protocol):
    """The one control-plane surface both backends implement."""

    backend: str                                   # "sim" | "serve"
    time_unit: str                                 # "ns" | "steps"

    def create_tenant(self, tenant_id: int, slo: SLOPolicy, *,
                      name: str = "", workload=None) -> ECTX: ...
    def destroy_tenant(self, tenant_id: int) -> List[Event]: ...
    def inject(self, work: Sequence) -> None: ...
    def attach_controller(self, controller) -> None: ...
    def run_until(self, t: Optional[float] = None) -> float: ...
    def now(self) -> float: ...
    def poll_events(self, tenant_id: int) -> List[Event]: ...
    def report(self, spec: Optional[ScenarioSpec] = None) -> RunReport: ...


def _build_audit(spec: ScenarioSpec, backend: str, num_tenants: int,
                 time_unit: str):
    """Materialize the spec's ``SLOAudit`` (or None).

    ``spec.audit is None`` means auto: attach exactly when a QoS
    controller with at least one live p99 target is configured — the
    audit then watches the same targets the controller acts on, so
    every closed-loop run gets alert -> intervention attribution for
    free.  An explicit ``AuditSpec`` works without a controller too
    (targets fall back to the raw ``TenantSpec.p99_target`` values)."""
    a = spec.audit
    if a is not None and not a.enabled:
        return None
    if spec.controller is not None:
        targets = spec.controller.p99_targets(spec.tenants, backend,
                                              num_tenants)
    else:
        targets = [0.0] * num_tenants
        for i, t in enumerate(spec.tenants):
            targets[i] = t.p99_target
    if not any(targets):
        return None
    if a is None and spec.controller is None:
        return None
    from repro_torch.telemetry.slo_audit import SLOAudit, SLOAuditConfig
    cfg = SLOAuditConfig() if a is None else SLOAuditConfig(
        objective=a.objective, fast_windows=a.fast_windows,
        slow_windows=a.slow_windows, fast_burn=a.fast_burn,
        slow_burn=a.slow_burn)
    return SLOAudit(targets, config=cfg, time_unit=time_unit)


def _events_block(events: List[Event], extras: dict) -> List[dict]:
    """Serialize EQ events (bounded; the total count is always recorded)."""
    extras["events_total"] = len(events)
    return _jsonify([
        {"tenant": e.tenant, "kind": e.kind.value, "time": float(e.time),
         "detail": e.detail} for e in events[:MAX_REPORT_EVENTS]])


# ---------------------------------------------------------------------------
# simulator adapter
# ---------------------------------------------------------------------------
class SimRuntime:
    """Runtime adapter over the cycle-level PsPIN simulator.

    The underlying ``Simulator`` binds its tenant set at construction,
    so the adapter stages ``create_tenant`` calls and builds the
    simulator lazily on first ``inject``/``run_until`` (the "seal").
    ``destroy_tenant`` is not supported on this backend — a sim tenant
    lives for the whole scenario.
    """

    backend = "sim"
    time_unit = NS_UNIT

    def __init__(self, *, scheduler: str = "wlbvt", frag=None,
                 arb: str = "dwrr", fifo_capacity: int = 4096,
                 io_demand_weights=None, record_timeline: bool = False,
                 control_interval_ns: float = 8000.0,
                 datapath: str = "event", trace: bool = False,
                 trace_depth: int = 65536,
                 trace_decision_depth: int = 8192):
        self._kw = dict(scheduler=scheduler, frag=frag, arb=arb,
                        fifo_capacity=fifo_capacity,
                        io_demand_weights=io_demand_weights,
                        record_timeline=record_timeline,
                        control_interval_ns=control_interval_ns,
                        trace=trace, trace_depth=trace_depth,
                        trace_decision_depth=trace_decision_depth)
        self._datapath = datapath
        self._tenants: List[ECTX] = []
        self._controller = None
        self._bus = None
        self._audit = None
        self._sim = None
        self._events: List[Event] = []
        self._pending: List = []      # injected, not yet run packets
        self.result = None            # last SimResult (deprecated surface)

    @classmethod
    def from_spec(cls, spec: ScenarioSpec, **overrides) -> "SimRuntime":
        weights = None
        if spec.io_demand_weights == "demand":
            weights = _io_demand(spec)
        kw = dict(scheduler=spec.scheduler, frag=spec.frag(),
                  arb=spec.arbiter, fifo_capacity=spec.fifo_capacity,
                  io_demand_weights=weights,
                  record_timeline=spec.record_timeline,
                  control_interval_ns=(spec.controller.interval_ns
                                       if spec.controller else 8000.0),
                  datapath=spec.datapath or "event")
        kw.update(overrides)
        return cls(**kw)

    # -- lifecycle ----------------------------------------------------------
    def create_tenant(self, tenant_id: int, slo: SLOPolicy, *,
                      name: str = "", workload=None) -> ECTX:
        if self._sim is not None:
            raise RuntimeError("sim backend binds tenants at seal time; "
                               "create_tenant before the first inject/run")
        if tenant_id != len(self._tenants):
            raise ValueError(f"sim tenant ids are dense: expected "
                             f"{len(self._tenants)}, got {tenant_id}")
        e = ECTX(tenant_id=tenant_id, name=name or f"tenant{tenant_id}",
                 slo=slo, kernel=workload)
        self._tenants.append(e)
        return e

    def destroy_tenant(self, tenant_id: int) -> List[Event]:
        raise NotImplementedError(
            "the cycle simulator has no mid-run tenant teardown; "
            "use the serve backend for lifecycle churn")

    def attach_controller(self, controller) -> None:
        if self._sim is not None:
            raise RuntimeError("attach_controller before the first run")
        self._controller = controller

    def attach_bus(self, bus) -> None:
        """Attach a ``MetricsBus``: the simulator publishes one
        ``BusFrame`` per committed IO window (DESIGN.md §11.1)."""
        self._bus = bus
        if self._sim is not None:
            self._sim.attach_bus(bus)

    def attach_slo_audit(self, audit) -> None:
        """Attach an ``SLOAudit``: burn-rate alerts land in the EQ
        stream / trace plane and ``report().extras['slo_audit']``."""
        self._audit = audit
        if self._sim is not None:
            self._sim.attach_slo_audit(audit)

    def _seal(self):
        if self._sim is None:
            from repro_torch.sim.fastpath import build_simulator
            if not self._tenants:
                raise RuntimeError("no tenants created")
            self._sim = build_simulator(
                self._tenants, datapath=self._datapath,
                controller=self._controller, **self._kw)
            if self._bus is not None:
                self._sim.attach_bus(self._bus)
            if self._audit is not None:
                self._sim.attach_slo_audit(self._audit)
        return self._sim

    # -- clock + work -------------------------------------------------------
    def inject(self, work: Sequence) -> None:
        """Queue work: a ``TracePacket`` sequence, or a ``TraceArrays``
        column bundle (the SoA twin — cheap at million-packet scale)."""
        self._seal()                  # tenant set is bound from here on
        from repro_torch.sim.traffic import TraceArrays
        if isinstance(work, TraceArrays):
            self._pending.append(work)
        else:
            self._pending.extend(work)

    def run_until(self, t: Optional[float] = None) -> float:
        from repro_torch.sim.traffic import (TraceArrays, TracePacket,
                                       merge_trace_arrays)
        sim = self._seal()
        pending, self._pending = self._pending, []
        if any(isinstance(p, TraceArrays) for p in pending):
            # normalize mixed injections: lift loose packets into one
            # column bundle, then merge chronologically
            packets = [p for p in pending if isinstance(p, TracePacket)]
            bundles = [p for p in pending if isinstance(p, TraceArrays)]
            if packets:
                bundles.append(TraceArrays.from_packets(packets))
            pending = merge_trace_arrays(*bundles)
            if self._datapath == "event":    # event loop wants packets
                pending = pending.to_packets()
        self.result = sim.run(pending, horizon=t)
        self._events.extend(self.result.events)
        return sim.now

    def now(self) -> float:
        return self._seal().now

    @property
    def trace(self):
        """The flight recorder, or None (tracing off / not sealed)."""
        return self._sim.trace if self._sim is not None else None

    def flush_trace(self) -> None:
        """Flush in-flight trace state (open spans / queued packets)
        into the recorder — call once after the run, before export."""
        if self._sim is not None:
            self._sim.trace_flush(self._sim.now)

    def poll_events(self, tenant_id: int) -> List[Event]:
        out = [e for e in self._events if e.tenant == tenant_id]
        self._events = [e for e in self._events if e.tenant != tenant_id]
        return out

    # -- scenario runner ----------------------------------------------------
    def run(self, spec: ScenarioSpec) -> RunReport:
        for i, t in enumerate(spec.tenants):
            self.create_tenant(i, t.slo(), name=t.name,
                               workload=t.workload.build())
        if spec.controller is not None and self._controller is None:
            from repro_torch.telemetry import QoSController
            T = len(spec.tenants)
            self.attach_controller(QoSController(
                base_weights=np.ones(T),
                p99_targets=spec.controller.p99_targets(
                    spec.tenants, "sim", T)))
        if self._audit is None:
            audit = _build_audit(spec, "sim", len(spec.tenants), NS_UNIT)
            if audit is not None:
                self.attach_slo_audit(audit)
        self.inject(build_traces(spec, arrays=spec.datapath == "batched"))
        # horizon_us > 0: fixed measurement window (queued work is cut
        # off); default drains every queued event
        self.run_until(spec.horizon_us * 1e3 if spec.horizon_us else None)
        return self.report(spec)

    # -- report -------------------------------------------------------------
    def report(self, spec: Optional[ScenarioSpec] = None) -> RunReport:
        if self.result is None:
            self.run_until(None)
        res = self.result
        from repro_torch.telemetry import tenant_report
        from repro_torch.telemetry.metrics import C_IDX
        snap = res.telemetry.snapshot()
        tenants: Dict[int, TenantReport] = {}
        for i, e in enumerate(self._tenants):
            st = res.stats[i]
            counts = snap["counts"][i]
            tenants[i] = TenantReport(
                tenant_id=i, name=e.name,
                arrivals=int(counts[C_IDX["arrivals"]]),
                completed=int(st.completed), killed=int(st.killed),
                drops=int(st.drops),
                rejected=int(counts[C_IDX["rejected"]]),
                ecn_marks=int(counts[C_IDX["ecn_marks"]]),
                bytes_in=float(counts[C_IDX["bytes_in"]]),
                bytes_out=float(counts[C_IDX["bytes_out"]]),
                throughput=float(res.throughput_gbps(i)),
                p50_latency=float(res.p50(i)),
                p99_latency=float(res.p99(i)),
                latency_samples=len(st.kernel_times),
                extra=_jsonify({
                    "fct": float(st.fct),
                    "io_bytes_done": float(st.io_bytes_done),
                    "served_payload_bytes": float(st.served_payload_bytes),
                }))
        extras: dict = {}
        if self.trace is not None:
            extras["trace_summary"] = self.trace.trace_summary()
        if self._audit is not None:
            extras["slo_audit"] = self._audit.summary()
        events = _events_block(self._events, extras)
        names = {i: e.name for i, e in enumerate(self._tenants)}
        return RunReport(
            scenario=spec.name if spec else "",
            backend="sim", time_unit=NS_UNIT, duration=float(res.time),
            scheduler=self._kw["scheduler"], arbiter=self._kw["arb"],
            seed=int(spec.seed) if spec else 0,
            jain_pu=float(res.jain_pu_timeavg),
            jain_io=float(res.jain_io_timeavg),
            tenants=tenants, events=events,
            telemetry=_jsonify(tenant_report(res.telemetry, names=names)),
            spec=_jsonify(spec.to_dict()) if spec else None,
            extras=_jsonify(extras))


def build_traces(spec: ScenarioSpec, *, arrays: bool = False):
    """Materialize the per-tenant packet traces a spec describes.

    ``arrays=True`` returns the ``TraceArrays`` column bundle instead of
    ``TracePacket`` objects — identical packet sequence, no per-packet
    Python objects (the batched and sweep datapaths consume it directly)."""
    from repro_torch.sim.traffic import make_trace_arrays, merge_trace_arrays
    traces = []
    for i, t in enumerate(spec.tenants):
        a = t.arrival
        traces.append(make_trace_arrays(
            i, size=a.size, share=a.share, seed=spec.seed + a.seed_offset,
            duration_ns=a.duration_frac * spec.duration_us * 1e3))
    merged = merge_trace_arrays(*traces)
    return merged if arrays else merged.to_packets()


def _io_demand(spec: ScenarioSpec) -> List[float]:
    """Per-tenant IO byte demand (bytes/ns) — the denominator weights of
    windowed IO fairness under heterogeneous DMA amplification."""
    from repro_torch.configs.osmosis_pspin import PSPIN
    link_bns = PSPIN.ingress_gbps / 8.0
    out = []
    for t in spec.tenants:
        wl = t.workload.build()
        payload = max(1, t.arrival.size - PSPIN.header_bytes)
        out.append(t.arrival.share * link_bns * wl.io_bytes(payload)
                   / t.arrival.size)
    return out


# ---------------------------------------------------------------------------
# serving adapter
# ---------------------------------------------------------------------------
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
        """Attach a ``MetricsBus``: the engine publishes one
        ``BusFrame`` per observation interval (steps)."""
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

    @property
    def trace(self):
        """The flight recorder, or None (tracing off)."""
        return self.engine.trace

    def flush_trace(self) -> None:
        """Flush in-flight trace state (open spans / queued requests)
        into the recorder — call once after the run, before export."""
        self.engine.trace_flush(float(self.engine.step_count))

    def poll_events(self, tenant_id: int) -> List[Event]:
        mine = [e for e in self._events if e.tenant == tenant_id]
        self._events = [e for e in self._events if e.tenant != tenant_id]
        if tenant_id in self.engine.eq:
            mine.extend(self.engine.poll_events(tenant_id))
        return mine

    # -- scenario runner ----------------------------------------------------
    def run(self, spec: ScenarioSpec) -> RunReport:
        quota_default = spec.serve.max_len * max(
            1, spec.serve.max_slots // max(len(spec.tenants), 1))
        for i, t in enumerate(spec.tenants):
            slo = t.slo()
            if slo.kv_quota_tokens == 0:
                slo = dataclasses.replace(slo, kv_quota_tokens=quota_default)
            self.create_tenant(i, slo, name=t.name)
        if spec.controller is not None:
            from repro_torch.telemetry import QoSController
            T = self.ecfg.max_tenants
            self.attach_controller(QoSController(
                base_weights=np.ones(T),
                p99_targets=spec.controller.p99_targets(
                    spec.tenants, "serve", T)))
        if self.engine.slo_audit is None:
            audit = _build_audit(spec, "serve", self.ecfg.max_tenants,
                                 STEPS_UNIT)
            if audit is not None:
                self.attach_slo_audit(audit)
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
        # non-destructive (matching SimRuntime.report): poll_events still
        # delivers these to the tenant afterwards
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
        if eng.trace is not None:
            extras["trace_summary"] = eng.trace.trace_summary()
        if eng.slo_audit is not None:
            extras["slo_audit"] = eng.slo_audit.summary()
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


# ---------------------------------------------------------------------------
# one-call entry point
# ---------------------------------------------------------------------------
def make_runtime(spec: ScenarioSpec, backend: str, *, executor=None,
                 **overrides) -> Runtime:
    if backend == "sim":
        return SimRuntime.from_spec(spec, **overrides)
    if backend == "serve":
        return ServeRuntime.from_spec(spec, executor=executor, **overrides)
    raise ValueError(f"unknown backend {backend!r} (want 'sim' or 'serve')")


def run_scenario(spec: ScenarioSpec, backend: str = "sim", *,
                 executor=None, validate: bool = True) -> RunReport:
    """Run a declarative scenario on either backend -> ``RunReport``."""
    if spec.analytic:
        return _run_analytic(spec)
    from repro_torch.fleet.spec import FleetSpec
    if isinstance(spec, FleetSpec):
        # multi-NIC scenarios run the fleet engine (N per-NIC sims over
        # the modeled switch) and return the aggregated report
        from repro_torch.fleet.engine import run_fleet
        return run_fleet(spec, backend, validate=validate)
    rt = make_runtime(spec, backend, executor=executor)
    rep = rt.run(spec)
    return rep.validate() if validate else rep


def _run_analytic(spec: ScenarioSpec) -> RunReport:
    """Closed-form scenarios (no event loop): currently ``ppb`` — the
    paper's Fig. 3 service-time-vs-budget classification."""
    if spec.analytic != "ppb":
        raise ValueError(f"unknown analytic scenario {spec.analytic!r}")
    from repro_torch.sim.scenarios import service_time_vs_ppb
    sizes = [64, 128, 256, 512, 1024, 2048, 4096]
    table = service_time_vs_ppb(sizes)
    rows = [[w, int(p), float(svc), float(budget), int(svc <= budget)]
            for w, lst in table.items() for (p, svc, budget) in lst]
    return RunReport(
        scenario=spec.name, backend="sim", time_unit=NS_UNIT, duration=0.0,
        scheduler=spec.scheduler, arbiter=spec.arbiter, seed=spec.seed,
        jain_pu=1.0, jain_io=1.0, tenants={}, events=[],
        telemetry=None, spec=_jsonify(spec.to_dict()),
        extras=_jsonify({"analytic": "ppb",
                         "columns": ["workload", "pkt_bytes", "service_ns",
                                     "ppb_ns", "fits"],
                         "table": rows})).validate()
