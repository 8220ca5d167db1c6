"""The port's sweep datapath (``repro_torch.sim.devicepath``) against the
JAX package's host ``BatchedSimulator``.

The contract (DESIGN.md §13): in ``precision="exact"`` the device path is
bit-identical to the host batched datapath on decisions (the completion
stream), the EQ event stream, per-tenant statistics and the final
scheduler state; the one tolerance is the Jain time-average, whose host
fold sums the active set in another order (1e-9, as in
tests/test_devicepath.py).  The JAX package's own device path cannot run
its exact mode on the installed jax, so its host simulator is the
oracle here, under ``tests/test_devicepath.py``'s ``_host_run`` /
``_assert_parity`` contract.  The port's own ``BatchedSimulator`` is a
second oracle under the same contract (``_port_host_run``), the one the
card's machine, which has no JAX, holds the card's sweep against
(``tests/test_torch_sweep_card.py``, ``chip_smoke.py`` phase 20).
Everything runs on the CPU (``device="cpu"``): the plain step stands in
for the kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _prop import given, settings, st  # hypothesis or seeded fallback

jax = pytest.importorskip("jax")

from repro.api import get_scenario as jax_get_scenario  # noqa: E402
from repro.sim.devicepath import run_device as jax_run_device  # noqa: E402
from repro_torch.api import (ArrivalSpec, ScenarioSpec, TenantSpec,  # noqa: E402
                             WorkloadSpec, get_scenario)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sim.devicepath import (DevicePathError,  # noqa: E402
                                        device_eligible, run_device,
                                        run_sweep_specs)

_STAT_FIELDS = ("completed", "killed", "drops", "served_payload_bytes",
                "first_arrival", "last_completion", "kernel_time_count",
                "kernel_time_sum")


def _to_jax(spec):
    """The same spec in the JAX package's types (serde round trip)."""
    from repro.api import ScenarioSpec as JaxScenarioSpec
    return JaxScenarioSpec.from_dict(spec.to_dict())


def _host_run(spec):
    """The oracle: the same spec on the JAX package's host batched
    datapath (tests/test_devicepath.py::_host_run)."""
    from repro.api.runtime import build_traces
    from repro.core.slo import ECTX
    from repro.sim.fastpath import build_simulator
    spec = _to_jax(spec)
    tenants = [ECTX(tenant_id=i, name=t.name, slo=t.slo(),
                    kernel=t.workload.build())
               for i, t in enumerate(spec.tenants)]
    sim = build_simulator(tenants, datapath="batched",
                          scheduler=spec.scheduler, frag=spec.frag(),
                          arb=spec.arbiter,
                          fifo_capacity=spec.fifo_capacity,
                          record_completions=True)
    ta = build_traces(spec, arrays=True)
    horizon = spec.horizon_us * 1e3 if spec.horizon_us else None
    return sim.run(ta, horizon=horizon)


def _port_host_run(spec):
    """The same spec on the port's own host batched datapath."""
    from repro_torch.api import build_traces
    from repro_torch.core.slo import ECTX
    from repro_torch.sim.fastpath import build_simulator
    tenants = [ECTX(tenant_id=i, name=t.name, slo=t.slo(),
                    kernel=t.workload.build())
               for i, t in enumerate(spec.tenants)]
    sim = build_simulator(tenants, datapath="batched",
                          scheduler=spec.scheduler, frag=spec.frag(),
                          arb=spec.arbiter,
                          fifo_capacity=spec.fifo_capacity,
                          record_completions=True)
    horizon = spec.horizon_us * 1e3 if spec.horizon_us else None
    return sim.run(build_traces(spec, arrays=True), horizon=horizon)


def _events(res):
    return [(e.tenant, e.kind.value, e.time) for e in res.events]


def _assert_parity(spec, h, d):
    assert d.time == h.time
    assert d.completions == h.completions
    assert _events(d) == _events(h)
    for i in range(len(spec.tenants)):
        hs, ds = h.stats[i], d.stats[i]
        for f in _STAT_FIELDS:
            assert getattr(ds, f) == getattr(hs, f), (i, f)
        assert (ds.kernel_time_percentile(99)
                == hs.kernel_time_percentile(99)), i
    for k in ("prio", "total_occup", "bvt", "kv_pressure"):
        np.testing.assert_array_equal(np.asarray(d.sched_state[k]),
                                      np.asarray(h.sched_state[k]), k)
    assert abs(d.jain_pu_timeavg - h.jain_pu_timeavg) <= 1e-9


def _fig9(**kw):
    spec = get_scenario("fig9_congestor_victim",
                        duration_us=kw.pop("duration_us", 30.0),
                        **{k: kw.pop(k) for k in ("scheduler",)
                           if k in kw})
    return dataclasses.replace(spec, record_timeline=False, **kw)


# ---------------------------------------------------------------------------
# golden parity: port device path == JAX host batched, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leg,impl,kw", [
    ("wlbvt", "", {}),
    ("wlbvt_ref", "jnp_ref", {"duration_us": 10.0}),
    ("wlbvt_pallas", "pallas", {"duration_us": 10.0}),
    ("rr", "", {"scheduler": "rr"}),
    ("fifo8", "", {"fifo_capacity": 8}),
    ("horizon", "", {"duration_us": 40.0, "horizon_us": 20.0}),
])
def test_fig9_parity(leg, impl, kw):
    spec = _fig9(**kw)
    d = run_device(spec, impl=impl, device="cpu")
    _assert_parity(spec, _host_run(spec), d)
    if leg == "fifo8":
        assert sum(s.drops for s in d.stats.values()) > 0  # drops exercised


def _budget_kill(spec):
    return dataclasses.replace(spec, tenants=tuple(
        dataclasses.replace(t, kernel_cycle_limit=300,
                            total_cycle_limit=20000) for t in spec.tenants))


@pytest.mark.parametrize("leg", ["wlbvt", "rr", "fifo8", "budget_kill",
                                 "mix"])
def test_parity_against_port_host_simulator(leg):
    """The port's device path against the port's own host batched
    datapath: no JAX anywhere in the leg."""
    if leg == "mix":
        specs = _mix([1.0, 2.0, 3.0], [0.3, 0.35, 0.4], [0, 900, 0],
                     "wlbvt", seeds=(0, 1, 2, 3))
    elif leg == "budget_kill":
        specs = [_budget_kill(_fig9(duration_us=15.0))]
    else:
        specs = [_fig9(duration_us=20.0, **{
            "wlbvt": {}, "rr": {"scheduler": "rr"},
            "fifo8": {"fifo_capacity": 8}}[leg])]
    device = run_sweep_specs(specs, record_completions=True, device="cpu")
    for spec, d in zip(specs, device):
        h = _port_host_run(spec)
        _assert_parity(spec, h, d)
        if leg == "fifo8":
            assert sum(s.drops for s in h.stats.values()) > 0
        if leg == "budget_kill":
            assert sum(s.killed for s in h.stats.values()) > 0


def test_budget_kill_parity():
    spec = _fig9(duration_us=15.0)
    ten = tuple(dataclasses.replace(t, kernel_cycle_limit=300,
                                    total_cycle_limit=20000)
                for t in spec.tenants)
    spec = dataclasses.replace(spec, tenants=ten)
    h, d = _host_run(spec), run_device(spec, device="cpu")
    assert sum(s.killed for s in h.stats.values()) > 0  # kills exercised
    _assert_parity(spec, h, d)


def test_sweep_batch_matches_single_replica_runs():
    """The replica axis: an R=3 batch equals three R=1 runs."""
    base = _fig9(duration_us=8.0)
    specs = [dataclasses.replace(base, seed=s) for s in (0, 1, 2)]
    batch = run_sweep_specs(specs, record_completions=True, device="cpu")
    for spec, br in zip(specs, batch):
        sr = run_device(spec, device="cpu")
        assert br.time == sr.time
        assert br.completions == sr.completions
        assert _events(br) == _events(sr)
        for i in range(len(spec.tenants)):
            for f in _STAT_FIELDS:
                assert (getattr(br.stats[i], f)
                        == getattr(sr.stats[i], f)), (spec.seed, i, f)


def test_sweep_rejects_mixed_scheduler():
    a, b = _fig9(duration_us=5.0), _fig9(duration_us=5.0, scheduler="rr")
    with pytest.raises(DevicePathError):
        run_sweep_specs([a, b], device="cpu")


# ---------------------------------------------------------------------------
# randomized sweep parity (tests/test_devicepath.py::_mix)
# ---------------------------------------------------------------------------
def _mix(prios, slopes, limits, scheduler, seeds):
    T = len(prios)
    tens = tuple(
        TenantSpec(f"t{i}",
                   workload=WorkloadSpec(name=f"w{i}", compute_base=40.0,
                                         compute_per_byte=slopes[i]),
                   arrival=ArrivalSpec(size=512, share=1.0 / T,
                                       seed_offset=i),
                   priority=prios[i], kernel_cycle_limit=limits[i])
        for i in range(T))
    base = ScenarioSpec(name="prop_mix", tenants=tens, duration_us=4.0,
                        scheduler=scheduler)
    return [dataclasses.replace(base, seed=s) for s in seeds]


@settings(max_examples=10, deadline=None)
@given(st.data())
def test_random_sweep_parity(data):
    T = 3
    prios = [data.draw(st.floats(0.5, 4.0)) for _ in range(T)]
    slopes = [data.draw(st.floats(0.0, 0.8)) for _ in range(T)]
    limits = [data.draw(st.integers(0, 1)) * data.draw(
        st.integers(200, 2000)) for _ in range(T)]
    sched = "wlbvt" if data.draw(st.booleans()) else "rr"
    specs = _mix(prios, slopes, limits, sched, seeds=(0, 1))
    device = run_sweep_specs(specs, record_completions=True, device="cpu")
    for spec, d in zip(specs, device):
        h = _host_run(spec)
        assert d.time == h.time
        assert d.completions == h.completions
        assert _events(d) == _events(h)
        for i in range(T):
            for f in _STAT_FIELDS:
                assert (getattr(d.stats[i], f)
                        == getattr(h.stats[i], f)), (spec.seed, i, f)
        assert abs(d.jain_pu_timeavg - h.jain_pu_timeavg) <= 1e-9


# ---------------------------------------------------------------------------
# fast mode (float32) against the JAX package's device path, which runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheduler", ["wlbvt", "rr"])
def test_fast_mode_matches_jax_device_path(scheduler):
    """float32 lanes: the same float32 ops in the same order, so equal
    per-tenant counts, completion stream, event stream and Jain index."""
    spec = _fig9(duration_us=6.0, scheduler=scheduler)
    d = run_device(spec, precision="fast", device="cpu")
    j = jax_run_device(_to_jax(spec), precision="fast")
    for i in range(len(spec.tenants)):
        for f in ("completed", "killed", "drops", "kernel_time_count"):
            assert getattr(d.stats[i], f) == getattr(j.stats[i], f), (i, f)
    assert d.time == j.time
    assert d.completions == j.completions
    assert _events(d) == _events(j)
    assert d.jain_pu_timeavg == j.jain_pu_timeavg
    assert [(e.tenant, e.kind.value) for e in d.events] == \
        [(e.tenant, e.kind.value) for e in j.events]


# ---------------------------------------------------------------------------
# contract gates, report rows, no fallback
# ---------------------------------------------------------------------------
def test_device_eligible_gates():
    spec = _fig9(duration_us=10.0)
    assert device_eligible(spec) is None
    assert device_eligible(
        dataclasses.replace(spec, record_timeline=True)) is not None
    assert device_eligible(
        dataclasses.replace(spec, scheduler="drr")) is not None
    io_t = dataclasses.replace(
        spec.tenants[0], workload=WorkloadSpec(name="io",
                                               io_kind="dma_read"))
    assert device_eligible(dataclasses.replace(
        spec, tenants=(io_t,) + spec.tenants[1:])) is not None
    with pytest.raises(DevicePathError):
        run_sweep_specs([dataclasses.replace(spec, record_timeline=True)],
                        device="cpu")
    # the paper scenarios outside the contract say why
    for name in ("fig10_hol_blocking", "fig13_io_mixture",
                 "qos_closed_loop", "ppb_service_time"):
        why = device_eligible(get_scenario(name))
        assert why, name
        with pytest.raises(DevicePathError, match="needs a host datapath"):
            run_device(get_scenario(name), device="cpu")
    # with the timeline off, the compute-only paper scenarios fit
    assert device_eligible(get_scenario("fig11_standalone")) is None


def test_summary_row_shape():
    spec = _fig9(duration_us=4.0)
    row = run_device(spec, precision="fast",
                     device="cpu").summary_row({"seed": 3})
    assert row["scenario"] == spec.name and row["knobs"] == {"seed": 3}
    assert len(row["tenants"]) == len(spec.tenants)
    for t in row["tenants"]:
        for k in ("name", "completed", "drops", "killed", "ecn_marks",
                  "throughput_gbps", "p50_kernel_ns", "p99_kernel_ns"):
            assert k in t


def test_cpu_run_launches_no_kernel_and_cuda_default_raises():
    spec = _fig9(duration_us=5.0)
    ops.reset_launches()
    run_device(spec, device="cpu")
    assert ops.LAUNCHES["wlbvt_select"] == 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_device(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep_specs([spec])


def test_slot_meta_bit_packing():
    """pkt | kill<<30 | budget-kill<<31 in int32: the sign bit holds the
    budget-kill flag and unpacks by arithmetic shift."""
    pkt = torch.tensor([5, 7, 9], dtype=torch.int32)
    kill = torch.tensor([False, True, True])
    bk = torch.tensor([False, False, True])
    meta = torch.where(bk, pkt | -(1 << 30),
                       torch.where(kill, pkt | (1 << 30), pkt))
    want = (pkt.numpy().astype(np.int64) | (kill.numpy() << 30)
            | (bk.numpy().astype(np.int64) << 31)).astype(np.int32)
    assert meta.numpy().tolist() == want.tolist()
    assert (((meta >> 30) & 1) != 0).tolist() == kill.tolist()
    assert (((meta >> 31) & 1) != 0).tolist() == bk.tolist()
    assert (meta & ((1 << 30) - 1)).tolist() == pkt.tolist()
