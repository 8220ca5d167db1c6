"""The port's fleet plane (``repro_torch.fleet``: multi-NIC co-simulation
over the modeled VOQ/crossbar switch, global QoS, live migration)
against the JAX package's ``repro.fleet``, case for case with
``tests/test_fleet.py``.

Every fleet scenario's RunReport JSON equals the reference's byte for
byte on both sim datapaths: ``fleet_fabric`` and ``fleet_incast`` at 40
us, ``fleet_migrate`` and ``fleet_incast`` at their published sizes,
the migration arms, tracked switch ids with tiny VOQs, and the fleet
trace.  On the port alone: the report schema, the N = 1 ideal fabric
against the single NIC, the incast and migration acceptance properties,
drift-free identity across the datapaths and the OpenMetrics fleet
golden.  A property test feeds both packages' ``CrossbarSwitch`` the
same random injections and advances.  The JAX legs skip where JAX is
missing (the card's machine).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from _prop import given, settings, st

from repro_torch.api import get_scenario, list_scenarios, run_scenario
from repro_torch.fleet import (FLEET_EXTRAS_KEYS, CrossbarSwitch, FleetSpec,
                               GlobalQoS, GlobalQoSSpec, fleet_metric_rows,
                               run_fleet)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "openmetrics_schema.fleet.golden")
FLEET = ("fleet_fabric", "fleet_incast", "fleet_migrate")

# (scenario, parameters): test_fleet.py's 40 us cuts, the published
# sizes, the migration's control arm and its state-transfer link
REPORT_CASES = [
    ("fleet_fabric", {"duration_us": 40.0}),
    ("fleet_incast", {"duration_us": 40.0}),
    ("fleet_incast", {}),
    ("fleet_migrate", {}),
    ("fleet_migrate", {"migrate": False}),
]

_CACHE = {}


def _port(name, datapath="event", **kw):
    """The port's report of a registered fleet scenario (cached)."""
    key = (name, datapath, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = run_fleet(get_scenario(name, datapath=datapath, **kw))
    return _CACHE[key]


def _jax_api():
    pytest.importorskip("jax")
    import repro.api as api
    return api


def _drift_free(rep):
    """``tests/test_fleet.py``'s projection: the report but the
    time-averaged Jain accumulators and the spec echoes."""
    d = rep.to_dict()
    d.pop("spec")
    d.pop("jain_pu"), d.pop("jain_io")
    for pn in d["extras"]["fleet"]["per_nic"]:
        pn.pop("spec")
        pn.pop("jain_pu"), pn.pop("jain_io")
    return json.dumps(d, sort_keys=True)


# ---------------------------------------------------------------------------
# registry + report schema
# ---------------------------------------------------------------------------
def test_fleet_scenarios_registered_as_in_the_reference():
    api = _jax_api()
    port = {s["name"]: s for s in list_scenarios()}
    ref = {s["name"]: s for s in api.list_scenarios()}
    assert set(FLEET) <= set(port)
    assert port == ref
    for name in FLEET:
        spec = get_scenario(name)
        assert isinstance(spec, FleetSpec)
        d = spec.to_dict()
        assert (json.dumps(d, sort_keys=True) == json.dumps(
            api.get_scenario(name).to_dict(), sort_keys=True))
        assert FleetSpec.from_dict(json.loads(json.dumps(d))) == spec


def test_fleet_report_validates_and_carries_fleet_block():
    rep = _port("fleet_fabric", duration_us=40.0)
    rep.validate()
    fl = rep.extras["fleet"]
    assert all(k in fl for k in FLEET_EXTRAS_KEYS)
    assert len(fl["per_nic"]) == fl["num_nics"] == 4
    assert all(r.extra["nic"].startswith("nic") for r in rep.tenants.values())


@pytest.mark.parametrize("key", ["jain_fleet", "per_nic", "switch"])
def test_fleet_block_schema_is_enforced(key):
    rep = run_fleet(get_scenario("fleet_fabric", duration_us=40.0))
    del rep.extras["fleet"][key]
    with pytest.raises(ValueError, match="fleet extras missing"):
        rep.validate()


def test_fleet_per_nic_count_is_enforced():
    rep = run_fleet(get_scenario("fleet_fabric", duration_us=40.0))
    rep.extras["fleet"]["per_nic"].pop()
    with pytest.raises(ValueError, match="per_nic has 3 reports for 4"):
        rep.validate()


def test_fleet_rejects_serve_backend():
    with pytest.raises(ValueError, match="sim backend"):
        run_fleet(get_scenario("fleet_fabric", duration_us=40.0),
                  backend="serve")
    # run_scenario routes a FleetSpec to the fleet engine
    spec = get_scenario("fleet_fabric", duration_us=20.0)
    assert (run_scenario(spec).to_json()
            == run_fleet(spec).to_json())


# ---------------------------------------------------------------------------
# the reports against the reference, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("datapath", ["event", "batched"])
@pytest.mark.parametrize("name,kw", REPORT_CASES)
def test_fleet_report_json_equals_reference(name, kw, datapath):
    api = _jax_api()
    from repro.fleet import run_fleet as jax_run_fleet
    want = jax_run_fleet(api.get_scenario(name, datapath=datapath, **kw))
    assert _port(name, datapath, **kw).to_json() == want.to_json()


@pytest.mark.parametrize("datapath", ["event", "batched"])
def test_tiny_voqs_with_tracked_ids_equal_reference(datapath):
    """``fleet_incast`` with 4-deep VOQs and the id sets: drops, their
    ``SWITCH_DROP`` events and the id-set conservation as the
    reference's."""
    api = _jax_api()
    from repro.fleet import run_fleet as jax_run_fleet
    kw = dict(voq_depth=4, duration_us=12.0, datapath=datapath)
    rep = run_fleet(get_scenario("fleet_incast", **kw),
                    track_switch_ids=True)
    want = jax_run_fleet(api.get_scenario("fleet_incast", **kw),
                         track_switch_ids=True)
    assert rep.to_json() == want.to_json()
    sw = rep.extras["fleet"]["switch"]
    assert sw["drops_total"] > 0
    assert (sum(sw["injected"]) + sum(sw["replayed"])
            == sum(sw["delivered"]) + sw["drops_total"] + sw["inflight"])
    assert (len([e for e in rep.events if e["kind"] == "switch_drop"])
            == sw["drops_total"])
    assert sum(r.extra["switch_drops"]
               for r in rep.tenants.values()) == sw["drops_total"]


def test_migration_with_state_link_and_fleet_trace_equals_reference():
    """A finite migration link (the handoff grows with the drained
    bytes) and ``trace_fleet`` (switch spans, the FLEET_MIGRATE
    decision) on both packages."""
    api = _jax_api()
    from repro.fleet import run_fleet as jax_run_fleet
    kw = dict(migrate=True, datapath="batched")
    change = dict(migration_gbps=1.0, trace_fleet=True)
    rep = run_fleet(dataclasses.replace(
        get_scenario("fleet_migrate", **kw), **change))
    want = jax_run_fleet(dataclasses.replace(
        api.get_scenario("fleet_migrate", **kw), **change))
    assert rep.to_json() == want.to_json()
    m = rep.extras["fleet"]["migrations"][0]
    size = rep.spec["tenants"][m["tenant"]]["arrival"]["size"]
    assert m["packets"] > 0
    assert (m["done_t"] - m["t"]
            == rep.spec["migration_delay_ns"] + m["packets"] * size * 8.0)
    ts = rep.extras["trace_summary"]
    assert ts["decisions_recorded"] > 0 and ts["spans_recorded"] > 0


def test_fleet_metric_rows_equal_reference():
    _jax_api()
    from repro.fleet import fleet_metric_rows as jax_rows
    for name in ("fleet_fabric", "fleet_migrate"):
        kw = {"duration_us": 40.0} if name == "fleet_fabric" else {}
        fl = _port(name, **kw).extras["fleet"]
        assert fleet_metric_rows(fl) == jax_rows(fl)


# ---------------------------------------------------------------------------
# N=1 ideal fabric == the plain single-NIC datapath
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("datapath", ["event", "batched"])
def test_n1_ideal_fabric_bit_identical_to_single_nic(datapath):
    from repro_torch.api.spec import ScenarioSpec
    base = get_scenario("qos_closed_loop", duration_us=60.0)
    fs = FleetSpec(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(ScenarioSpec)},
                   num_nics=1, link_gbps=0.0, prop_delay_ns=0.0)
    fleet = run_fleet(fs.replace(datapath=datapath))
    ref = run_scenario(fs.plain().replace(datapath=datapath), "sim")
    assert (json.dumps(fleet.extras["fleet"]["per_nic"][0], sort_keys=True)
            == json.dumps(ref.to_dict(), sort_keys=True))


# ---------------------------------------------------------------------------
# VOQ prevents HoL blocking under the 16-NIC incast (published size)
# ---------------------------------------------------------------------------
def test_incast_saturates_hot_output_only():
    util = _port("fleet_incast").extras["fleet"]["switch"][
        "link_utilization"]
    assert util[0] > 0.9
    assert util[-1] < 0.1


def test_incast_voq_keeps_quiet_pair_flat():
    rep = _port("fleet_incast")
    spec = rep.spec
    n = spec["num_nics"]
    lat = np.asarray(rep.extras["fleet"]["switch"]["pair_latency_mean"])
    quiet_size = spec["tenants"][-1]["arrival"]["size"]
    ideal = quiet_size * 8.0 / spec["link_gbps"] + spec["prop_delay_ns"]
    quiet = lat[n - 1, n - 1]
    assert 0.0 < quiet < 3.0 * ideal
    assert lat[:n - 1, 0].mean() > 10.0 * quiet


# ---------------------------------------------------------------------------
# global QoS migrates the victim; p99 improves, Jain holds
# ---------------------------------------------------------------------------
def test_migration_fires_with_eq_events():
    rep = _port("fleet_migrate")
    fl = rep.extras["fleet"]
    assert fl["migrations_total"] >= 1
    m = fl["migrations"][0]
    assert (m["tenant"], m["src"], m["dst"]) == (2, 0, 1)
    assert fl["placement_final"][2] == 1
    kinds = [e["kind"] for e in rep.events]
    assert "migrate_start" in kinds and "migrate_done" in kinds
    t_alert = min(e["time"] for e in rep.events
                  if e["kind"] == "slo_alert" and e["tenant"] == 2)
    t_mig = min(e["time"] for e in rep.events
                if e["kind"] == "migrate_start")
    assert t_alert < t_mig
    assert m["done_t"] - m["t"] == rep.spec["migration_delay_ns"]
    assert _port("fleet_migrate", migrate=False).extras["fleet"][
        "migrations_total"] == 0


def test_migration_improves_victim_p99_and_jain_holds():
    mig, ctl = _port("fleet_migrate"), _port("fleet_migrate", migrate=False)
    a, b = mig.extras["fleet"], ctl.extras["fleet"]
    assert a["sojourn_p99"][2] < 0.5 * b["sojourn_p99"][2]
    assert a["sojourn_p99"][2] < mig.spec["tenants"][2]["p99_target"]
    assert a["jain_fleet"] >= b["jain_fleet"] - 0.05
    t2m, t2s = mig.tenants[2], ctl.tenants[2]
    assert t2m.completed + t2m.drops == t2s.completed + t2s.drops


# ---------------------------------------------------------------------------
# identical across the event and batched datapaths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("fleet_fabric", {"duration_us": 40.0}),
    ("fleet_incast", {"duration_us": 40.0}),
    ("fleet_migrate", {}),
])
def test_fleet_results_identical_across_datapaths(name, kw):
    assert (_drift_free(_port(name, "event", **kw))
            == _drift_free(_port(name, "batched", **kw)))


# ---------------------------------------------------------------------------
# the switch, against the reference's, on random fabrics
# ---------------------------------------------------------------------------
def _switch_pair(data, tracer_pair):
    from repro.fleet.switch import CrossbarSwitch as JaxSwitch
    n = data.draw(st.integers(min_value=2, max_value=4))
    kw = dict(
        num_tenants=n,
        link_gbps=data.draw(st.floats(min_value=10.0, max_value=400.0)),
        prop_delay_ns=data.draw(st.floats(min_value=0.0, max_value=100.0)),
        voq_depth=data.draw(st.integers(min_value=1, max_value=4)),
        arbiter=("rr" if data.draw(st.booleans()) else "mdrr"),
        quantum_bytes=data.draw(st.integers(min_value=64, max_value=4096)),
        track_ids=True)
    return (n, CrossbarSwitch(n, tracer=tracer_pair[0], **kw),
            JaxSwitch(n, tracer=tracer_pair[1], **kw))


def _same_switch(a, b) -> None:
    assert json.dumps(a.stats()) == json.dumps(b.stats())
    assert a.inflight == b.inflight and a.idle == b.idle
    assert ([(e.tenant, e.kind.value, e.time, e.detail) for e in a.events]
            == [(e.tenant, e.kind.value, e.time, e.detail)
                for e in b.events])
    assert (a.injected_ids, a.delivered_ids, a.dropped_ids) == (
        b.injected_ids, b.delivered_ids, b.dropped_ids)


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_switch_matches_reference_on_random_injections(data):
    """Both packages' switches (with their trace recorders) take the same
    injections, replays, bulk arrival streams and advances: the same
    deliveries, drops, ``SWITCH_DROP`` events, counters and spans, and
    the conservation law at every advance."""
    pytest.importorskip("jax")
    from repro.core.events import EventKind as JaxEventKind
    from repro.telemetry.trace import TraceRecorder as JaxRecorder
    from repro_torch.telemetry.trace import TraceRecorder
    tracers = (TraceRecorder(4), JaxRecorder(4))
    n, port, ref = _switch_pair(data, tracers)
    t = 0.0
    for k in range(data.draw(st.integers(min_value=1, max_value=60))):
        t += data.draw(st.floats(min_value=0.0, max_value=40.0))
        pkt = (t, data.draw(st.integers(min_value=0, max_value=n - 1)),
               data.draw(st.integers(min_value=0, max_value=n - 1)),
               data.draw(st.integers(min_value=0, max_value=n - 1)),
               data.draw(st.integers(min_value=64, max_value=2048)))
        replay = data.draw(st.integers(min_value=0, max_value=9)) == 0
        for sw in (port, ref):
            sw.inject(*pkt, replay=replay)
        if k % 5 == 0:
            got, want = port.advance(t), ref.advance(t)
            assert got == want
            assert (int(port.injected.sum()) + int(port.replayed.sum())
                    == int(port.delivered.sum()) + int(port.dropped.sum())
                    + port.inflight)
    # a time-sorted bulk arrival stream, as the control-plane-off slice
    if data.draw(st.booleans()):
        m = data.draw(st.integers(min_value=1, max_value=40))
        gaps = data.draw(st.lists(st.floats(min_value=0.0, max_value=30.0),
                                  min_size=m, max_size=m))
        times = t + np.cumsum(np.asarray(gaps, np.float64))
        cols = [np.asarray(data.draw(st.lists(
            st.integers(min_value=lo, max_value=hi), min_size=m,
            max_size=m)), np.int64)
            for lo, hi in ((0, n - 1), (0, n - 1), (0, n - 1), (64, 2048))]
        for sw in (port, ref):
            sw.advance(t)
            sw.inject_bulk(times, *cols)
        t = float(times[-1])
        assert port.advance(t) == ref.advance(t)
    for _ in range(64):                        # drain the fabric
        if port.idle and ref.idle:
            break
        t += 1e6
        assert port.advance(t) == ref.advance(t)
    assert port.idle and port.inflight == 0
    assert port.conservation_ok() and ref.conservation_ok()
    _same_switch(port, ref)
    drops = [e for e in port.events if e.kind.value
             == JaxEventKind.SWITCH_DROP.value]
    assert len(drops) == int(port.dropped.sum())
    for tr in tracers:
        tr.commit()
    assert tracers[0].trace_summary() == tracers[1].trace_summary()
    rows = tracers[0].rows(), tracers[1].rows()
    assert rows[0].keys() == rows[1].keys()
    for key in rows[0]:
        np.testing.assert_array_equal(rows[0][key], rows[1][key])


@settings(max_examples=20, deadline=None)
@given(st.data())
def test_global_qos_ticks_match_reference(data):
    """The fleet tier's boosts, migration plans and cooldowns on random
    per-NIC frames, against the reference's ``GlobalQoS``."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    from repro.fleet.qos import GlobalQoS as JaxGlobalQoS
    from repro.fleet.spec import GlobalQoSSpec as JaxGlobalQoSSpec
    N = data.draw(st.integers(min_value=1, max_value=3))
    T = data.draw(st.integers(min_value=1, max_value=5))
    cfg = dict(rebalance=data.draw(st.booleans()),
               migrate=data.draw(st.booleans()),
               rebalance_gain=1.3, boost_cap=4.0, max_migrations=3,
               cooldown_epochs=data.draw(st.integers(min_value=0,
                                                     max_value=3)),
               load_margin=1.1)
    targets = data.draw(st.lists(st.floats(min_value=0.0, max_value=2.0),
                                 min_size=T, max_size=T))
    port = GlobalQoS(GlobalQoSSpec(**cfg), num_tenants=T, num_nics=N,
                     p99_targets=targets)
    ref = JaxGlobalQoS(JaxGlobalQoSSpec(**cfg), num_tenants=T, num_nics=N,
                       p99_targets=targets)
    placement = [i % N for i in range(T)]
    for epoch in range(8):
        frames = {}
        for k in range(N):
            if data.draw(st.booleans()):
                row = data.draw(st.lists(st.floats(min_value=0.0,
                                                   max_value=3.0),
                                         min_size=2 * T, max_size=2 * T))
                frames[k] = SimpleNamespace(signals=SimpleNamespace(
                    p99=np.asarray(row[:T]), queue_mean=np.asarray(row[T:])))
        got = port.tick(epoch, frames, placement)
        assert got == ref.tick(epoch, frames, placement)
        for (tenant, _src, dst) in got[0]:
            placement[tenant] = dst
        np.testing.assert_array_equal(port.gboost, ref.gboost)
    assert port.summary() == ref.summary()


# ---------------------------------------------------------------------------
# observability: the fleet export
# ---------------------------------------------------------------------------
def test_fleet_openmetrics_schema_matches_golden(tmp_path):
    from repro_torch.launch.scenario import run_one
    from repro_torch.telemetry.export import schema_lines
    run_one("fleet_fabric", "sim", {}, fast=True, export_dir=str(tmp_path))
    text = (tmp_path / "fleet_fabric.sim.om.txt").read_text()
    assert schema_lines(text) == open(GOLDEN).read().splitlines()
    assert 'nic=""' not in text
    assert 'nic="nic0"' in text


def test_fleet_exports_equal_reference(tmp_path):
    """``run_one --export`` of a fleet on both packages: the OpenMetrics
    text (fabric rows included), every JSONL frame and the report."""
    _jax_api()
    from repro.launch.scenario import run_one as jax_run_one
    from repro_torch.launch.scenario import run_one
    kw = {"duration_us": 24.0}
    rep = run_one("fleet_migrate", "sim", kw, export_dir=str(tmp_path / "p"))
    want = jax_run_one("fleet_migrate", "sim", kw,
                       export_dir=str(tmp_path / "r"))
    assert rep.to_json() == want.to_json()
    for ext in ("om.txt", "jsonl"):
        got = (tmp_path / "p" / f"fleet_migrate.sim.{ext}").read_bytes()
        assert got and got == (
            tmp_path / "r" / f"fleet_migrate.sim.{ext}").read_bytes(), ext


def test_fleet_runs_on_the_host_whatever_the_device():
    """The fabric has no card path: the CLI's fleet branch is host code
    even when ``device`` names the card (there is none here)."""
    from repro_torch.launch.scenario import run_one
    rep = run_one("fleet_fabric", "sim", {"duration_us": 20.0},
                  device="cuda")
    assert rep.extras["fleet"]["num_nics"] == 4
    assert rep.to_json() == run_fleet(
        get_scenario("fleet_fabric", duration_us=20.0)).to_json()
