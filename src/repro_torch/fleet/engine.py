"""Fleet engine: N per-NIC simulators co-stepped over the modeled
switch fabric (DESIGN.md §12).

Layering (bottom up):

  * N ``SimRuntime``s — each runs the FleetSpec's single-NIC twin
    (``spec.plain()``) on either sim datapath, with its own AIMD
    controller / SLO audit, publishing per-window ``BusFrame``s tagged
    ``nic=nic<k>`` onto one shared MetricsBus;
  * one ``CrossbarSwitch`` — tenant ``i`` enters the fabric at input
    port ``i % N`` and exits at ``placement[i]``, picking up VOQ wait
    + serialization + propagation delay;
  * the epoch loop — inject the trace slice for ``[t, t+epoch_ns)``
    into the fabric, advance it, feed its deliveries to the
    destination engines, step every engine to the epoch edge;
  * the ``GlobalQoS`` tier — every ``interval_epochs`` epochs it reads
    the freshest frame per NIC and either rescales scheduler base
    weights or live-migrates a tenant (drain source FMQ, bump
    placement, replay the drained packets through the fabric after
    ``migration_delay_ns``, bracketed by MIGRATE_START/MIGRATE_DONE
    EQ events).

The N=1 ideal-fabric configuration short-circuits the epoch loop and
replays ``SimRuntime.run``'s exact single-shot sequence, so its
per-NIC report is bit-identical to ``run_scenario(spec.plain())``
(pinned in tests/test_torch_fleet.py).  All fleet-tier decisions read
only drift-free signals, keeping the aggregated report byte-identical
across the event and batched datapaths.  A copy of the JAX package's
host numpy module: its fleet reports equal the reference's byte for
byte on both datapaths.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.report import (TIME_UNITS, RunReport, TenantReport,
                                     _jsonify)
from repro_torch.api.runtime import (SimRuntime, _build_audit,
                                     _events_block, build_traces)
from repro_torch.core.accounting import jain_fairness
from repro_torch.core.events import Event, EventKind
from repro_torch.fleet.qos import GlobalQoS
from repro_torch.fleet.spec import FleetSpec
from repro_torch.fleet.switch import CrossbarSwitch

NS_UNIT = TIME_UNITS[0]

# contract of RunReport.extras["fleet"]; report.validate() checks these
FLEET_EXTRAS_KEYS = (
    "num_nics", "epoch_ns", "epochs", "placement_initial",
    "placement_final", "switch", "migrations", "migrations_total",
    "jain_fleet", "sojourn_p99", "global_qos", "per_nic")

_GQ_SUB_DEPTH = 8192   # frames buffered between global-QoS ticks


def _nic_label(k: int) -> str:
    return f"nic{k}"


class FleetEngine:
    """One fleet run: construction wires the engines/fabric/control
    tier; ``run()`` drives the co-simulation and returns the
    aggregated ``RunReport``."""

    def __init__(self, spec: FleetSpec, *, bus=None,
                 track_switch_ids: bool = False):
        if not isinstance(spec, FleetSpec):
            raise TypeError("FleetEngine needs a FleetSpec")
        if spec.num_nics < 1:
            raise ValueError("num_nics must be >= 1")
        if spec.epoch_ns <= 0:
            raise ValueError("epoch_ns must be > 0")
        self.spec = spec
        self.plain = spec.plain()
        N, T = spec.num_nics, len(spec.tenants)
        self.N, self.T = N, T
        self.placement = list(spec.initial_placement())
        if len(self.placement) != T or any(
                not 0 <= p < N for p in self.placement):
            raise ValueError(f"placement must map {T} tenants to [0,{N})")
        gq = spec.global_qos
        if gq is not None and gq.rebalance and spec.controller is None:
            raise ValueError("global_qos.rebalance needs a per-NIC "
                             "ControllerSpec to re-apply base weights")

        self._own_bus = False
        if bus is None and gq is not None:
            from repro_torch.telemetry.bus import MetricsBus
            bus = MetricsBus()
            self._own_bus = True
        self.bus = bus

        self.tracer = None
        if spec.trace_fleet:
            from repro_torch.telemetry.trace import TraceRecorder
            self.tracer = TraceRecorder(max(T, 1))
        self.switch = CrossbarSwitch(
            N, num_tenants=T, link_gbps=spec.link_gbps,
            prop_delay_ns=spec.prop_delay_ns, voq_depth=spec.voq_depth,
            arbiter=spec.switch_arbiter, quantum_bytes=spec.quantum_bytes,
            tracer=self.tracer, track_ids=track_switch_ids)

        # per-NIC engines: every NIC hosts the full dense tenant table
        # (sim tenant ids are dense; a tenant placed elsewhere simply
        # never receives traffic here until a migration lands it)
        self.runtimes: List[SimRuntime] = []
        self._base0: List[Tuple[np.ndarray, ...]] = []
        for k in range(N):
            rt = SimRuntime.from_spec(self.plain)
            for i, t in enumerate(self.plain.tenants):
                rt.create_tenant(i, t.slo(), name=t.name,
                                 workload=t.workload.build())
            if self.plain.controller is not None:
                from repro_torch.telemetry import QoSController
                rt.attach_controller(QoSController(
                    base_weights=np.ones(T),
                    p99_targets=self.plain.controller.p99_targets(
                        self.plain.tenants, "sim", T)))
            audit = _build_audit(self.plain, "sim", T, NS_UNIT)
            if audit is not None:
                rt.attach_slo_audit(audit)
            if self.bus is not None:
                rt.attach_bus(self.bus)
            sim = rt._seal()
            sim.obs_nic = _nic_label(k)
            self.runtimes.append(rt)
            self._base0.append(tuple(a.copy() for a in sim._sched_base))

        self.gq: Optional[GlobalQoS] = None
        self._gq_sub = None
        if gq is not None:
            targets = np.zeros(T)
            for i, t in enumerate(spec.tenants):
                targets[i] = float(getattr(t, "p99_target", 0.0) or 0.0)
            self.gq = GlobalQoS(gq, num_tenants=T, num_nics=N,
                                p99_targets=targets)
            self._gq_sub = self.bus.subscribe(maxlen=_GQ_SUB_DEPTH,
                                              name="fleet-global-qos")

        self.fleet_events: List[Event] = []
        self.migrations: List[Dict] = []
        self.epochs = 0
        self._mig_uid = 1 << 40   # synthetic span uids, clear of packets
        self._single_shot = (N == 1 and self.switch.passthrough
                             and gq is None)

    # ------------------------------------------------------------ run

    def run(self) -> RunReport:
        horizon = (self.spec.horizon_us * 1e3
                   if self.spec.horizon_us else None)
        if self._single_shot:
            self._run_single_shot(horizon)
        else:
            self._run_epochs(horizon)
        if self._own_bus:
            self.bus.close()
        return self._report()

    def _run_single_shot(self, horizon: Optional[float]) -> None:
        """The exact ``SimRuntime.run`` sequence (one inject, one run),
        so the per-NIC report is bit-identical to ``run_scenario`` on
        the plain twin.  The ideal fabric reduces to counters."""
        rt = self.runtimes[0]
        ta = build_traces(self.spec, arrays=True)
        tens = np.asarray(ta.tenants, np.int64)
        self.switch.bulk_passthrough(tens, tens % self.N,
                                     np.zeros(len(tens), np.int64))
        work = ta if self.plain.datapath == "batched" else ta.to_packets()
        rt.inject(work)
        rt.run_until(horizon)

    def _run_epochs(self, horizon: Optional[float]) -> None:
        spec, sw = self.spec, self.switch
        ta = build_traces(spec, arrays=True)
        times = np.asarray(ta.times, np.float64)
        tens = np.asarray(ta.tenants, np.int64)
        sizes = np.asarray(ta.sizes, np.int64)
        n_pkts = len(times)
        cursor = 0
        t_cur = 0.0
        E = float(spec.epoch_ns)
        # with the control plane off nothing observes epoch boundaries —
        # traffic is open-loop (trace -> switch -> engines, no feedback),
        # and deliveries carry exact timestamps — so one big slice over
        # the remaining trace replaces the epoch loop; epoch-sized steps
        # remain only to drain the fabric tail without inflating
        # ``switch.now`` (and the utilization denominator) past the run
        one_slice = self.gq is None
        latest: Dict[int, object] = {}
        while True:
            t_next = t_cur + E
            if one_slice and cursor < n_pkts:
                t_next = max(t_next, float(times[n_pkts - 1]))
            if horizon is not None:
                t_next = min(t_next, horizon)
            hi = int(np.searchsorted(times, t_next, side="right"))
            if one_slice and hi > cursor:
                # placement is immutable without the control plane, so
                # the whole slice maps to ports in one array pass
                plc = np.asarray(self.placement, np.int64)
                ts = tens[cursor:hi]
                sw.inject_bulk(times[cursor:hi], ts % self.N, plc[ts],
                               ts, sizes[cursor:hi])
            else:
                for j in range(cursor, hi):
                    i = int(tens[j])
                    sw.inject(float(times[j]), i % self.N,
                              self.placement[i], i, int(sizes[j]))
            cursor = hi
            self._deliver(sw.advance(t_next))
            for rt in self.runtimes:
                rt.run_until(t_next)
            self.epochs += 1
            t_cur = t_next
            if self.gq is not None and \
                    self.epochs % self.gq.cfg.interval_epochs == 0:
                self._gq_tick(t_cur, latest)
            if horizon is not None and t_cur >= horizon:
                break
            if cursor >= n_pkts and sw.idle:
                break
        # drain whatever is still queued inside the engines (or replay
        # the final no-op slice when a horizon cut the run)
        for rt in self.runtimes:
            rt.run_until(horizon)

    def _deliver(self, deliveries) -> None:
        if not deliveries:
            return
        from repro_torch.sim.traffic import TraceArrays
        per: List[List[tuple]] = [[] for _ in range(self.N)]
        for (t, tenant, size, dst) in deliveries:
            per[dst].append((t, tenant, size))
        for k, rows in enumerate(per):
            if not rows:
                continue
            bundle = TraceArrays(
                times=np.array([r[0] for r in rows], np.float64),
                tenants=np.array([r[1] for r in rows], np.int64),
                sizes=np.array([r[2] for r in rows], np.int64))
            rt = self.runtimes[k]
            if self.plain.datapath == "batched":
                rt.inject(bundle)
            else:
                rt.inject(bundle.to_packets())

    # ------------------------------------------------- global QoS tier

    def _gq_tick(self, t: float, latest: Dict[int, object]) -> None:
        for f in self._gq_sub.drain():
            if f.nic.startswith("nic"):
                latest[int(f.nic[3:])] = f
        plans, boost_changed = self.gq.tick(self.epochs, latest,
                                            self.placement)
        if boost_changed:
            self._apply_gboost()
        for (tenant, src, dst) in plans:
            self._migrate(tenant, src, dst, t)

    def _apply_gboost(self) -> None:
        """Fold the fleet boost into every NIC's scheduler *base* rows;
        each NIC's AIMD controller re-applies live = base x local boost
        at its next qos tick (global floor, local trim)."""
        g = self.gq.gboost
        for k, rt in enumerate(self.runtimes):
            for arr, orig in zip(rt._sim._sched_base, self._base0[k]):
                arr[:] = orig * g

    def _migrate(self, tenant: int, src: int, dst: int, t: float) -> None:
        drained = self.runtimes[src]._sim.drain_tenant_queue(tenant)
        self.placement[tenant] = dst
        detail = f"{_nic_label(src)}->{_nic_label(dst)}"
        self.fleet_events.append(Event(
            tenant, EventKind.MIGRATE_START, t,
            detail=f"{detail} drained={len(drained)}"))
        # handoff = fixed drain/replay cost + serialized state transfer:
        # the drained queue's bytes cross the migration link (1 Gbps =
        # 1 bit/ns).  migration_gbps == 0 keeps the legacy fixed delay.
        delay = float(self.spec.migration_delay_ns)
        if self.spec.migration_gbps > 0:
            drained_bytes = sum(int(size) for (_a, size) in drained)
            delay += drained_bytes * 8.0 / float(self.spec.migration_gbps)
        t_rep = t + delay
        for (_arrival, size) in drained:
            self.switch.inject(t_rep, src, dst, tenant, int(size),
                               replay=True)
        self.fleet_events.append(Event(
            tenant, EventKind.MIGRATE_DONE, t_rep,
            detail=f"{detail} replayed={len(drained)}"))
        self.migrations.append({
            "t": float(t), "tenant": int(tenant), "src": int(src),
            "dst": int(dst), "packets": len(drained),
            "done_t": float(t_rep)})
        if self.tracer is not None:
            from repro_torch.telemetry import trace as TR
            uid = self._mig_uid
            self._mig_uid += 1
            self.tracer.span(TR.ST_SWITCH, uid, tenant, t, t_rep,
                             disp=TR.D_OK)
            self.tracer.decision(t, TR.K_FLEET_MIGRATE, tenant,
                                 TR.R_MIGRATION, n_elig=len(drained))

    # --------------------------------------------------------- report

    def _report(self) -> RunReport:
        spec = self.spec
        reps = [rt.report(self.plain) for rt in self.runtimes]
        tenants: Dict[int, TenantReport] = {}
        served = np.zeros(self.T)
        for i, tn in enumerate(spec.tenants):
            rows = [r.tenants[i] for r in reps]
            home = rows[self.placement[i]]
            for r in rows:
                served[i] += float(r.extra.get("served_payload_bytes", 0.0))
            extra = dict(home.extra)
            extra["nic"] = _nic_label(self.placement[i])
            extra["per_nic_completed"] = [int(r.completed) for r in rows]
            extra["switch_drops"] = int(self.switch.dropped[i])
            tenants[i] = TenantReport(
                tenant_id=i, name=tn.name,
                arrivals=sum(r.arrivals for r in rows),
                completed=sum(r.completed for r in rows),
                killed=sum(r.killed for r in rows),
                drops=sum(r.drops for r in rows),
                rejected=sum(r.rejected for r in rows),
                ecn_marks=sum(r.ecn_marks for r in rows),
                bytes_in=float(sum(r.bytes_in for r in rows)),
                bytes_out=float(sum(r.bytes_out for r in rows)),
                throughput=float(sum(r.throughput for r in rows)),
                p50_latency=float(home.p50_latency),
                p99_latency=float(home.p99_latency),
                latency_samples=sum(r.latency_samples for r in rows),
                extra=_jsonify(extra))

        events: List[Event] = []
        for rt in self.runtimes:
            events.extend(rt._events)
        events.extend(self.fleet_events)
        events.extend(self.switch.events)
        events.sort(key=lambda e: (e.time, e.tenant, e.kind.value))

        prio = np.array([t.priority for t in spec.tenants], np.float64)
        x = served / np.maximum(prio, 1e-12)
        jain_fleet = jain_fairness(x[x > 0]) if (x > 0).any() else 1.0

        # per-tenant arrival->completion p99 on the tenant's *final* NIC
        # (the kernel-time percentile in TenantReport.p99_latency excludes
        # FMQ wait, so migrations are invisible to it; this is the signal
        # the global QoS tier actually acts on)
        from repro_torch.telemetry.metrics import hist_quantile
        nic_p99 = [hist_quantile(rt._sim.tel.snapshot()["hist"], 0.99, np)
                   for rt in self.runtimes]
        sojourn_p99 = [float(nic_p99[self.placement[i]][i])
                       for i in range(self.T)]

        extras: dict = {}
        if self.tracer is not None:
            self.tracer.commit()
            extras["trace_summary"] = self.tracer.trace_summary()
        ev_block = _events_block(events, extras)
        extras["fleet"] = {
            "num_nics": self.N,
            "epoch_ns": float(spec.epoch_ns),
            "epochs": int(self.epochs),
            "placement_initial": list(spec.initial_placement()),
            "placement_final": list(self.placement),
            "switch": self.switch.stats(),
            "migrations": self.migrations,
            "migrations_total": len(self.migrations),
            "jain_fleet": float(jain_fleet),
            "sojourn_p99": sojourn_p99,
            "global_qos": (self.gq.summary() if self.gq is not None
                           else None),
            "per_nic": [r.to_dict() for r in reps],
        }
        duration = max([self.switch.now] + [r.duration for r in reps])
        jain_pu = float(np.clip(np.mean([r.jain_pu for r in reps]), 0, 1))
        jain_io = float(np.clip(np.mean([r.jain_io for r in reps]), 0, 1))
        return RunReport(
            scenario=spec.name, backend="sim", time_unit=NS_UNIT,
            duration=float(duration), scheduler=self.plain.scheduler,
            arbiter=self.plain.arbiter, seed=int(spec.seed),
            jain_pu=jain_pu, jain_io=jain_io,
            tenants=tenants, events=ev_block, telemetry=None,
            spec=_jsonify(spec.to_dict()), extras=_jsonify(extras))


def run_fleet(spec: FleetSpec, backend: str = "sim", *, bus=None,
              validate: bool = True,
              track_switch_ids: bool = False) -> RunReport:
    """Run a fleet scenario end to end and return the aggregated
    report (per-NIC reports ride in ``extras['fleet']['per_nic']``)."""
    if backend != "sim":
        raise ValueError(f"fleet scenarios run on the sim backend "
                         f"(got {backend!r})")
    eng = FleetEngine(spec, bus=bus, track_switch_ids=track_switch_ids)
    rep = eng.run()
    if validate:
        rep.validate()
    return rep


def fleet_metric_rows(fleet_block: Dict, backend: str = "sim"
                      ) -> List[Tuple[str, Dict[str, str], float]]:
    """Project a report's fleet block onto the fleet MetricSpecs
    (telemetry/export.py) as explicit ``(name, labels, value)`` rows —
    the OpenMetrics writer merges them into its rendered exposition."""
    rows: List[Tuple[str, Dict[str, str], float]] = []
    sw = fleet_block["switch"]
    migr_in = [0] * int(fleet_block["num_nics"])
    for m in fleet_block["migrations"]:
        migr_in[int(m["dst"])] += 1
    for k in range(int(fleet_block["num_nics"])):
        lab = {"backend": backend, "nic": _nic_label(k)}
        rows.append(("osmosis_switch_voq_depth_count", lab,
                     float(sw["voq_peak_out"][k])))
        rows.append(("osmosis_link_utilization_ratio", lab,
                     float(sw["link_utilization"][k])))
        rows.append(("osmosis_migrations_total", lab, float(migr_in[k])))
    return rows
