"""The port's host simulators (``repro_torch.sim``: the event-loop
``Simulator``, the batched ``BatchedSimulator``, ``sim/scenarios.py``) and
the FMQ / fragmentation / matching core against the JAX package.

The simulators are host numpy in both packages, so the contract is bit
for bit: the ``RunReport`` JSON of every registered single-NIC sim
scenario on both datapaths equals the JAX package's byte for byte (at
60 us or less), and the port reproduces the ``sim`` and
``sim_datapath`` entries of ``tests/data/golden_sched.json`` through the
generator's own specs (``tests/data/gen_golden.py``).
"""
import hashlib
import json
import os

import pytest
from _prop import given, settings, st  # hypothesis or seeded fallback

jax = pytest.importorskip("jax")

from repro.api import get_scenario as jax_get_scenario  # noqa: E402
from repro.api import run_scenario as jax_run_scenario  # noqa: E402
from repro_torch.api import get_scenario, list_scenarios, run_scenario  # noqa: E402
from repro_torch.core import (ECTX, FMQ, FragmentationPolicy,  # noqa: E402
                              MatchingEngine, MatchRule, PacketDescriptor,
                              PushResult, SLOPolicy, fragment_tokens,
                              fragment_transfer)
from repro_torch.sim.fastpath import (DATAPATHS, BatchedSimulator,  # noqa: E402
                                      build_simulator)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_sched.json")


def _dump(rep) -> str:
    return json.dumps(rep.to_dict(), sort_keys=True)


def _both(name, datapath, **params):
    """The same registered spec through both packages' ``run_scenario``."""
    spec = get_scenario(name, **params).replace(datapath=datapath)
    ref = jax_get_scenario(name, **params).replace(datapath=datapath)
    assert json.dumps(spec.to_dict(), sort_keys=True) == json.dumps(
        ref.to_dict(), sort_keys=True)
    return run_scenario(spec, "sim"), jax_run_scenario(ref, "sim")


# every registered single-NIC sim scenario, cut to <= 60 us; fig10's three
# fragmentation modes and its FIFO bus, fig13's DWRR legs (hardware,
# software, off) and its reference-PsPIN leg (rr on the FIFO bus)
SIM_CASES = [
    ("fig9_congestor_victim", {"duration_us": 30.0}),
    ("fig9_congestor_victim", {"duration_us": 30.0, "scheduler": "rr"}),
    ("fig10_hol_blocking", {"duration_us": 6.0}),
    ("fig10_hol_blocking", {"duration_us": 6.0, "frag_mode": "software"}),
    ("fig10_hol_blocking", {"duration_us": 6.0, "frag_mode": "off"}),
    ("fig10_hol_blocking", {"duration_us": 6.0, "arb": "fifo",
                            "frag_mode": "off"}),
    ("fig11_standalone", {"duration_us": 30.0}),
    ("fig11_standalone", {"duration_us": 30.0, "osmosis": False,
                          "workload": "filtering"}),
    ("fig12_compute_mixture", {"duration_us": 5.0}),
    ("fig13_io_mixture", {"duration_us": 8.0}),
    ("fig13_io_mixture", {"duration_us": 8.0, "frag_mode": "software"}),
    ("fig13_io_mixture", {"duration_us": 8.0, "frag_mode": "off"}),
    ("fig13_io_mixture", {"duration_us": 8.0, "scheduler": "rr"}),
    ("fleet_sweep", {"duration_us": 6.0}),
    ("qos_closed_loop", {"duration_us": 60.0}),
    ("qos_closed_loop", {"duration_us": 30.0, "controller": False}),
]


def test_sim_cases_cover_the_registry():
    """Every single-NIC sim scenario has a case here; the fleet plane's
    multi-NIC scenarios are tests/test_torch_fleet.py's."""
    from repro_torch.fleet import FleetSpec
    sim = {s["name"] for s in list_scenarios()
           if "sim" in s["backends"] and not s["analytic"]}
    fleet = {n for n in sim if isinstance(get_scenario(n), FleetSpec)}
    assert fleet == {"fleet_fabric", "fleet_incast", "fleet_migrate"}
    assert sim - fleet == {name for name, _ in SIM_CASES}


@pytest.mark.parametrize("datapath", ["event", "batched"])
@pytest.mark.parametrize("name,params", SIM_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SIM_CASES)])
def test_run_report_equals_reference(name, params, datapath):
    port, ref = _both(name, datapath, **params)
    assert _dump(port) == _dump(ref)
    assert port.tenants and sum(t.completed for t in port.tenants.values())
    if name == "qos_closed_loop" and params.get("controller", True):
        # the controller and the (auto-attached) SLO audit both ran
        audit = port.extras["slo_audit"]
        assert audit["alerts"] and audit["interventions"]


def test_analytic_ppb_report_equals_reference():
    port = run_scenario(get_scenario("ppb_service_time"))
    ref = jax_run_scenario(jax_get_scenario("ppb_service_time"))
    assert _dump(port) == _dump(ref)
    assert port.extras["table"]


# ---------------------------------------------------------------------------
# golden_sched.json: the generator's specs through the port
# ---------------------------------------------------------------------------
def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_sim_entries():
    """``gen_golden.sim_trace`` through the port's scenario shims."""
    from repro_torch.sim.scenarios import (run_congestor_victim_compute,
                                           run_hol_blocking)
    want = _golden()["sim"]
    for sched in ("wlbvt", "rr"):
        res = run_congestor_victim_compute(sched, duration_us=60)
        got = {
            "time": round(res.time, 6),
            "jain_pu": round(res.jain_pu_timeavg, 9),
            "completed": [res.stats[i].completed for i in range(2)],
            "kernel_time_sum": [round(sum(res.stats[i].kernel_times), 3)
                                for i in range(2)],
        }
        assert got == want[f"cv_{sched}"], sched
    res = run_hol_blocking(
        FragmentationPolicy(mode="hardware", fragment_bytes=512),
        duration_us=40)
    got = {
        "time": round(res.time, 6),
        "jain_io": round(res.jain_io_timeavg, 9),
        "completed": [res.stats[i].completed for i in range(2)],
        "io_bytes": [round(res.stats[i].io_bytes_done, 3)
                     for i in range(2)],
        "kernel_time_sum": [round(sum(res.stats[i].kernel_times), 3)
                            for i in range(2)],
    }
    assert got == want["hol_dwrr_hw"]


@pytest.mark.parametrize("datapath", ["event", "batched"])
def test_golden_sim_datapath(datapath):
    """``gen_golden.sim_datapath_trace``: a drop/mark/kill-heavy flood;
    per-packet completions and the EQ stream, on both datapaths."""
    from repro_torch.sim.traffic import equal_share_traces
    from repro_torch.sim.workloads import spin_workload
    T = 4
    tenants = []
    for i in range(T):
        if i == 0:
            wl, limit = spin_workload("victim", 0.6), 0
        elif i == 1:
            wl, limit = spin_workload("congestor1", 8.0), 0
        else:
            wl, limit = spin_workload(f"congestor{i}", 8.0), 3000
        tenants.append(ECTX(
            tenant_id=i, name=wl.name,
            slo=SLOPolicy(priority=1.0, kernel_cycle_limit=limit),
            kernel=wl))
    sim = build_simulator(tenants, datapath=datapath, fifo_capacity=64,
                          record_completions=True)
    trace = equal_share_traces(T, sizes=[512] * T, duration_ns=80000.0,
                               arrays=True)
    res = sim.run(trace if datapath == "batched" else trace.to_packets())
    comp = [[t, round(x, 6)] for t, x in res.completions]
    evs = [[e.tenant, e.kind.value, round(e.time, 6), e.detail]
           for e in res.events]

    def digest(seq):
        return hashlib.sha256(json.dumps(seq).encode()).hexdigest()[:16]

    got = {
        "n_completions": len(comp),
        "completions_head": comp[:40],
        "completions_sha": digest(comp),
        "n_events": len(evs),
        "events_head": evs[:40],
        "events_sha": digest(evs),
        "drops": [res.stats[i].drops for i in range(T)],
        "killed": [res.stats[i].killed for i in range(T)],
        "completed": [res.stats[i].completed for i in range(T)],
    }
    assert got == _golden()["sim_datapath"]
    assert sum(got["drops"]) and sum(got["killed"])


def test_datapaths_and_factory():
    assert DATAPATHS["batched"] is BatchedSimulator
    with pytest.raises(ValueError, match="unknown datapath"):
        build_simulator([], datapath="warp")


def test_trace_plane_raises():
    # the flight recorder is ported: trace=True builds one on both
    # datapaths instead of raising, and the default stays off
    from repro_torch.telemetry.trace import TraceRecorder
    e = ECTX(0, "t", SLOPolicy())
    for dp in DATAPATHS:
        assert isinstance(build_simulator([e], datapath=dp,
                                          trace=True).trace, TraceRecorder)
    assert build_simulator([e]).trace is None


# ---------------------------------------------------------------------------
# fragmentation / matching / FMQ (tests/test_core.py,
# tests/test_frag_accounting.py), the port beside the reference
# ---------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(nbytes=st.integers(1, 1 << 20), frag=st.integers(16, 8192),
       mode=st.sampled_from(["hardware", "software", "off"]))
def test_fragment_transfer_equals_reference(nbytes, frag, mode):
    from repro.core import FragmentationPolicy as JFP
    from repro.core import fragment_transfer as jft
    got = fragment_transfer(FragmentationPolicy(mode=mode,
                                                fragment_bytes=frag),
                            tenant=2, transfer_id=5, nbytes=nbytes)
    want = jft(JFP(mode=mode, fragment_bytes=frag), tenant=2,
               transfer_id=5, nbytes=nbytes)
    assert [(f.tenant, f.transfer_id, f.seq, f.nbytes, f.last)
            for f in got] == [(f.tenant, f.transfer_id, f.seq, f.nbytes,
                               f.last) for f in want]
    assert sum(f.nbytes for f in got) == nbytes
    if mode != "off":
        assert all(0 < f.nbytes <= frag for f in got)


@settings(max_examples=50, deadline=None)
@given(total=st.integers(1, 100_000), chunk=st.integers(1, 4096))
def test_fragment_tokens_equals_reference(total, chunk):
    from repro.core import fragment_tokens as jtok
    assert list(fragment_tokens(total, chunk)) == list(jtok(total, chunk))


def test_last_fragment_carries_remainder():
    pol = FragmentationPolicy(mode="hardware", fragment_bytes=512)
    frags = fragment_transfer(pol, tenant=1, transfer_id=7, nbytes=1200)
    assert [f.nbytes for f in frags] == [512, 512, 176]
    assert [f.last for f in frags] == [False, False, True]
    assert [f.seq for f in frags] == [0, 1, 2]
    assert fragment_transfer(pol, 0, 0, 1024)[-1].nbytes == 512
    off = FragmentationPolicy(mode="off", fragment_bytes=64)
    assert len(fragment_transfer(off, 0, 0, 1 << 20)) == 1
    assert off.per_fragment_overhead == 0
    assert FragmentationPolicy(mode="software", sw_overhead_cycles=95
                               ).per_fragment_overhead == 95
    assert FragmentationPolicy(mode="hardware", hw_overhead_cycles=2
                               ).per_fragment_overhead == 2


def test_sim_charges_software_overhead_per_fragment():
    """A software-fragmented transfer pays sw_overhead_cycles * nfrags on
    the PU, on both datapaths."""
    from repro_torch.sim.scenarios import make_tenants
    from repro_torch.sim.traffic import TracePacket
    from repro_torch.sim.workloads import WorkloadModel
    wl = WorkloadModel("w", 40, 0.0, io_kind="dma_write",
                       io_fixed_bytes=2048)
    for datapath in DATAPATHS:
        times = {}
        for mode in ("off", "software"):
            pol = FragmentationPolicy(mode=mode, fragment_bytes=512,
                                      sw_overhead_cycles=95)
            sim = build_simulator(make_tenants([wl]), datapath=datapath,
                                  frag=pol)
            res = sim.run([TracePacket(0.0, 0, 256)])
            times[mode] = res.stats[0].kernel_times[0]
        assert times["software"] - times["off"] == pytest.approx(95 * 4)


def test_matching_three_tuple():
    eng = MatchingEngine()
    eng.install(MatchRule(dst_ip=10, dst_port=80), fmq_index=3)
    eng.install(MatchRule(dst_ip=10), fmq_index=4)
    assert eng.match({"dst_ip": 10, "dst_port": 80}) == 3
    assert eng.match({"dst_ip": 10, "dst_port": 81}) == 4
    assert eng.match({"dst_ip": 11}) == -1  # conventional NIC path


@pytest.mark.parametrize("capacity,n", [(2, 3), (8, 12), (64, 70)])
def test_fmq_push_sequence_equals_reference(capacity, n):
    """Accept / ECN-mark / drop transitions and counters, push by push."""
    from repro.core import ECTX as JECTX
    from repro.core import FMQ as JFMQ
    from repro.core import PacketDescriptor as JPD
    from repro.core import SLOPolicy as JSLO
    q = FMQ(index=0, ectx=ECTX(0, "t", SLOPolicy()), capacity=capacity)
    j = JFMQ(index=0, ectx=JECTX(0, "t", JSLO()), capacity=capacity)
    got = [q.push(PacketDescriptor(0, 64, float(k))).value
           for k in range(n)]
    want = [j.push(JPD(0, 64, float(k))).value for k in range(n)]
    assert got == want
    assert PushResult.DROPPED.value in got
    for f in ("drops", "ecn_marks", "enqueued"):
        assert getattr(q, f) == getattr(j, f), f
    assert len(q) == len(j) == capacity
    assert q.pop().arrival == j.pop().arrival == 0.0
