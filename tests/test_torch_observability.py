"""The port's streaming observability plane (``telemetry/bus.py``,
``telemetry/export.py``, ``launch/dash.py``, the bus publish in
``core/engine_base.py`` and the scenario CLI's ``--export`` / ``--dash``)
against the JAX package's.

The bus's drop-oldest queue and sinks, the SLO audit landing in the
trace, both OpenMetrics schema goldens (``tests/data/openmetrics_schema.
{sim,serve}.golden``, through ``run_one(..., export_dir=...)`` and the
export CLI's ``--schema ... --golden ...`` gate), exported values
against the report and the dashboard (headless and as a sink) are held
on the port.  Then the same scenarios go through both packages with
the bus attached: every JSONL frame, the OpenMetrics text and the
RunReport JSON must be equal byte for byte on both sim datapaths and on
the serve backend (``NullExecutor``).  The JAX legs skip where JAX is
missing (the card's machine).
"""
import dataclasses
import io
import json
import os

import numpy as np
import pytest

from repro_torch.telemetry.bus import BusFrame, MetricsBus
from repro_torch.telemetry.metrics import COUNTERS, C_IDX
from repro_torch.telemetry.signals import SignalFrame
from repro_torch.telemetry.slo_audit import SLOAlert

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_SIM = os.path.join(HERE, "data", "openmetrics_schema.sim.golden")
GOLDEN_SERVE = os.path.join(HERE, "data",
                            "openmetrics_schema.serve.golden")


def _sig(T=2):
    z = np.zeros(T)
    return SignalFrame(p50=z.copy(), p99=z.copy(), ecn_rate=z.copy(),
                       drop_rate=z.copy(), service_debt=z.copy(),
                       kv_pressure=z.copy(), occupancy_mean=z.copy(),
                       queue_mean=z.copy(), jain_weighted=1.0,
                       lat_samples=z.copy())


def _frame(t=0.0, seq=0, T=2, alerts=()):
    counts = np.zeros((T, len(COUNTERS)), np.int64)
    counts[:, C_IDX["arrivals"]] = 1
    return BusFrame(t=t, seq=seq, time_unit="ns", backend="sim",
                    signals=_sig(T), counts=counts,
                    interval_counts=counts.copy(),
                    weights=np.ones(T), admit=np.ones(T, bool),
                    alerts=tuple(alerts))


# ---------------------------------------------------------------------------
# metrics bus
# ---------------------------------------------------------------------------
def test_bus_drop_oldest_bounded_queue():
    bus = MetricsBus()
    sub = bus.subscribe(maxlen=3, name="slow")
    for i in range(7):
        bus.publish(_frame(t=float(i), seq=i))
    assert len(sub) == 3
    assert sub.dropped == 4 and sub.delivered == 7
    assert [f.seq for f in sub.drain()] == [4, 5, 6]
    assert bus.dropped == 4


def test_bus_sinks_and_close():
    class Sink:
        def __init__(self):
            self.frames, self.closed = [], False

        def on_frame(self, fr):
            self.frames.append(fr.seq)

        def close(self):
            self.closed = True

    bus = MetricsBus()
    s = bus.add_sink(Sink())
    bus.publish(_frame(seq=0))
    bus.publish(_frame(seq=1))
    bus.close()
    bus.close()
    assert s.frames == [0, 1] and s.closed
    with pytest.raises(RuntimeError):
        bus.publish(_frame(seq=2))


def test_subscription_latest():
    bus = MetricsBus()
    sub = bus.subscribe(maxlen=4)
    assert sub.latest() is None
    for i in range(3):
        bus.publish(_frame(seq=i))
    assert sub.latest().seq == 2
    assert len(sub) == 0


# ---------------------------------------------------------------------------
# the audit in the trace
# ---------------------------------------------------------------------------
def _qos_traced(get_scenario, make_runtime, datapath):
    spec = get_scenario("qos_closed_loop", duration_us=120.0)
    rt = make_runtime(spec, "sim", trace=True, datapath=datapath)
    rep = rt.run(spec)
    rt.flush_trace()
    return rep, rt.trace


@pytest.mark.parametrize("datapath", ["event", "batched"])
def test_alert_and_intervention_land_in_trace(datapath):
    from repro_torch.api import get_scenario
    from repro_torch.api.runtime import make_runtime
    from repro_torch.telemetry.trace import K_QOS_INTERVENE, K_SLO_ALERT
    from repro_torch.telemetry.traceview import to_perfetto
    rep, tr = _qos_traced(get_scenario, make_runtime, datapath)
    d = tr.decision_rows()
    t_alert = d["time"][d["kind"] == K_SLO_ALERT]
    t_iv = d["time"][d["kind"] == K_QOS_INTERVENE]
    assert len(t_alert) and len(t_iv)
    sa = rep.extras["slo_audit"]["tenants"]["1"]
    assert float(t_alert.min()) == sa["first_alert_t"]
    assert sa["first_alert_t"] < sa["first_intervention_t"]
    evs = to_perfetto(tr)["traceEvents"]
    marks = {e["name"] for e in evs if e.get("ph") == "i"}
    assert marks & {"BURN_FAST", "BURN_SLOW"}
    assert "AIMD_WEIGHT" in marks
    pytest.importorskip("jax")
    from repro.api import get_scenario as jax_get_scenario
    from repro.api.runtime import make_runtime as jax_make_runtime
    jrep, jtr = _qos_traced(jax_get_scenario, jax_make_runtime, datapath)
    assert rep.to_json() == jrep.to_json()
    jd = jtr.decision_rows()
    for k in d:
        np.testing.assert_array_equal(d[k], jd[k], err_msg=k)


def test_report_validates_trace_summary_schema():
    from repro_torch.api.report import RunReport
    rep = RunReport(scenario="x", backend="sim", time_unit="ns",
                    duration=1.0, scheduler="wlbvt", arbiter="dwrr",
                    seed=0, jain_pu=1.0, jain_io=1.0,
                    extras={"trace_summary": {"spans_recorded": 1}})
    with pytest.raises(ValueError, match="trace_summary missing"):
        rep.validate()


def test_report_validates_slo_audit_schema():
    from repro_torch.api import get_scenario, run_scenario
    rep = run_scenario(get_scenario("qos_closed_loop", duration_us=60.0),
                       "sim")
    broken = dict(rep.extras["slo_audit"])
    del broken["interval_unit"]
    rep.extras["slo_audit"] = broken
    with pytest.raises(ValueError, match="slo_audit missing"):
        rep.validate()
    broken = dict(broken, interval_unit="steps")
    rep.extras["slo_audit"] = broken
    with pytest.raises(ValueError, match="interval_unit"):
        rep.validate()


# ---------------------------------------------------------------------------
# exporters + golden schema
# ---------------------------------------------------------------------------
def _golden(path):
    with open(path) as f:
        return [ln for ln in (x.strip() for x in f) if ln]


def test_openmetrics_schema_matches_golden(tmp_path):
    from repro_torch.launch.scenario import run_one
    from repro_torch.telemetry.export import schema_lines
    run_one("qos_closed_loop", "sim", {}, fast=True,
            export_dir=str(tmp_path))
    om = tmp_path / "qos_closed_loop.sim.om.txt"
    assert schema_lines(om.read_text()) == _golden(GOLDEN_SIM)
    lines = [json.loads(ln)
             for ln in open(tmp_path / "qos_closed_loop.sim.jsonl")]
    assert lines
    assert [r["seq"] for r in lines] == list(range(len(lines)))
    for r in lines:
        assert r["backend"] == "sim" and r["time_unit"] == "ns"
        assert "osmosis_p99_sojourn_ns" in r["metrics"]


def test_export_cli_golden_gate(tmp_path, capsys):
    from repro_torch.launch.scenario import run_one
    from repro_torch.telemetry.export import main as export_main
    run_one("serve_congestor_victim", "serve", {},
            export_dir=str(tmp_path))
    om = str(tmp_path / "serve_congestor_victim.serve.om.txt")
    assert export_main(["--schema", om, "--golden", GOLDEN_SERVE]) == 0
    assert export_main(["--schema", om, "--golden", GOLDEN_SIM]) == 1
    assert export_main(["--schema", om]) == 0
    out = capsys.readouterr().out
    assert "schema ok" in out and "schema mismatch" in out


def test_exported_values_track_the_report(tmp_path):
    from repro_torch.launch.scenario import run_one
    rep = run_one("qos_closed_loop", "sim", {}, fast=True,
                  export_dir=str(tmp_path))
    lines = [json.loads(ln)
             for ln in open(tmp_path / "qos_closed_loop.sim.jsonl")]
    last = lines[-1]["metrics"]
    assert last["osmosis_completed_total"]["victim"] == \
        rep.tenants[1].completed
    assert last["osmosis_arrivals_total"]["congestor"] == \
        rep.tenants[0].arrivals


def test_metric_registry_equals_the_reference():
    """The port declares the reference's metric families field by field
    (name, kind, unit, help, labels) in the same order."""
    pytest.importorskip("jax")
    from repro.telemetry import export as JE
    from repro_torch.telemetry import export as E
    assert [dataclasses.astuple(m) for m in E.METRICS] == \
        [dataclasses.astuple(m) for m in JE.METRICS]
    assert E.DIMENSIONLESS_SUFFIXES == JE.DIMENSIONLESS_SUFFIXES


EXPORT_CASES = [("qos_closed_loop", "sim", "event"),
                ("qos_closed_loop", "sim", "batched"),
                ("fig9_congestor_victim", "sim", "batched"),
                ("qos_closed_loop", "serve", None),
                ("serve_congestor_victim", "serve", None)]


def _exported_run(pkg, name, backend, datapath, prefix):
    """``name`` on ``backend`` (at most 60 us on the sim, as ``--fast``
    runs it) with a bus carrying both exporters, from package ``pkg``."""
    api = pytest.importorskip(f"{pkg}.api")
    runtime = pytest.importorskip(f"{pkg}.api.runtime")
    bus_mod = pytest.importorskip(f"{pkg}.telemetry.bus")
    export = pytest.importorskip(f"{pkg}.telemetry.export")
    spec = api.get_scenario(name)
    if backend == "sim":
        spec = spec.replace(duration_us=min(spec.duration_us, 60.0),
                            datapath=datapath)
    rt = runtime.make_runtime(spec, backend)
    bus = bus_mod.MetricsBus()
    export.attach_exporters(bus, prefix, names={
        i: t.name for i, t in enumerate(spec.tenants)})
    rt.attach_bus(bus)
    try:
        return rt.run(spec).validate()
    finally:
        bus.close()


@pytest.mark.parametrize("name,backend,datapath", EXPORT_CASES)
def test_exports_equal_the_reference(tmp_path, name, backend, datapath):
    """The bus on both packages: every JSONL frame, the OpenMetrics text
    and the RunReport JSON equal byte for byte."""
    pytest.importorskip("jax")
    reps = {pkg: _exported_run(pkg, name, backend, datapath,
                               str(tmp_path / pkg))
            for pkg in ("repro_torch", "repro")}
    assert reps["repro_torch"].to_json() == reps["repro"].to_json()
    for ext in ("om.txt", "jsonl"):
        port = (tmp_path / f"repro_torch.{ext}").read_bytes()
        assert port and port == (tmp_path / f"repro.{ext}").read_bytes(), ext


# ---------------------------------------------------------------------------
# dashboard
# ---------------------------------------------------------------------------
def test_dashboard_headless_render():
    from repro_torch.launch.dash import Dashboard, demo_frame, main
    dash = Dashboard(names={0: "aggressor", 1: "victim"}, color=False)
    frame = demo_frame()
    dash.on_frame(frame)
    text = dash.render(frame)
    assert "victim" in text and "aggressor" in text
    assert "!F" in text and "ALERT victim" in text
    assert "\x1b[" not in text
    assert main(["--headless"]) == 0


def test_dashboard_as_bus_sink():
    from repro_torch.launch.dash import Dashboard
    out = io.StringIO()
    bus = MetricsBus()
    bus.add_sink(Dashboard(names={0: "a", 1: "b"}, out=out, color=False))
    alert = SLOAlert(t=1.0, tenant=1, window="fast", burn_rate=10.0,
                     p99=9.0, target=4.0)
    bus.publish(_frame(seq=0))
    bus.publish(_frame(seq=1, alerts=(alert,)))
    bus.close()
    text = out.getvalue()
    assert "frame=1" in text and "alerts_total=1" in text


def test_dashboard_renders_the_reference_panel():
    """The same frames through both packages' dashboards: the same
    panel text, alert markers included."""
    pytest.importorskip("jax")
    from repro.launch.dash import Dashboard as JaxDashboard
    from repro.launch.dash import demo_frame as jax_demo_frame
    from repro_torch.launch.dash import Dashboard, demo_frame
    outs = []
    for cls, frame in ((Dashboard, demo_frame()),
                       (JaxDashboard, jax_demo_frame())):
        out = io.StringIO()
        d = cls(names={0: "aggressor", 1: "victim"}, out=out, color=True)
        d.on_frame(frame)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and "\x1b[" in outs[0]
