"""The sweep datapath's scan: ``ops.sweep_scan``, its kernel
``csrc/sweep_scan.cu`` and its plain version ``ref.sweep_scan_ref``.

On the CPU, ``ops.sweep_scan`` runs the plain step; these tests hold it
against the step as the sweep ran it with the WLBVT round behind
``ops.wlbvt_select_rounds``, and against ``devicepath``'s CPU run (which
``tests/test_torch_devicepath.py`` holds against the JAX package).  They
check the wrapper's limits before any launch, and the invariant the
kernel's early exit rests on: a row that is drained or past its horizon
never changes again.  The ``gpu`` cases hold the kernel's ``[S, R]``
records and final state against the plain step on the card, element for
element; they skip without a card (the kernel has no CPU mode).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from _prop import given, settings, st  # hypothesis or seeded fallback

from repro_torch.api import (ArrivalSpec, ScenarioSpec, TenantSpec,
                             WorkloadSpec, get_scenario)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sweep_scan as K
from repro_torch.sim import devicepath as DP

RECORDS = ("eq_pack", "t", "comp_meta", "comp_ktime")


def _fig9(scheduler="wlbvt", **kw):
    spec = get_scenario("fig9_congestor_victim",
                        duration_us=kw.pop("duration_us", 5.0),
                        scheduler=scheduler)
    return dataclasses.replace(spec, record_timeline=False, **kw)


def _budget(scheduler="wlbvt", duration_us=6.0):
    """tests/test_torch_devicepath.py::test_budget_kill_parity's spec."""
    spec = _fig9(scheduler, duration_us=duration_us)
    ten = tuple(dataclasses.replace(t, kernel_cycle_limit=300,
                                    total_cycle_limit=20000)
                for t in spec.tenants)
    return dataclasses.replace(spec, tenants=ten)


def _mix(T, duration_us, scheduler="wlbvt", seeds=(0,), load=1.0, **kw):
    """chip_smoke.py's sweep mix at T tenants: a distinct cost slope,
    packet size and priority per tenant; ``load`` scales the slopes, so
    3 overloads the 32 PUs and fills the queues."""
    limits = kw.pop("limits", [0] * T)
    tlims = kw.pop("tlims", [0] * T)
    tens = tuple(
        TenantSpec(f"t{i}",
                   workload=WorkloadSpec(name=f"w{i}", compute_base=40.0,
                                         compute_per_byte=load * (
                                             0.3 + 0.05 * (i % 7))),
                   arrival=ArrivalSpec(size=256 + 64 * (i % 5),
                                       share=1.0 / T, seed_offset=i),
                   priority=1.0 + (i % 3), kernel_cycle_limit=limits[i],
                   total_cycle_limit=tlims[i])
        for i in range(T))
    base = ScenarioSpec(name=f"sweep_mix_T{T}", tenants=tens,
                        duration_us=duration_us, scheduler=scheduler, **kw)
    return [dataclasses.replace(base, seed=s) for s in seeds]


def _seeds(spec, n):
    return [dataclasses.replace(spec, seed=s) for s in range(n)]


def _geometry(specs, precision="exact", device="cpu"):
    """``(data, kw)``: the replica arrays and the scan's geometry."""
    _, data, kw = DP.scan_inputs(specs, DP.PRECISIONS[precision], device)
    return data, kw


def _assert_same(got, want, what=""):
    (gs, gy), (ws, wy) = got, want
    for name, a, b in zip(RECORDS, gy, wy):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        if not torch.equal(a, b):
            s, r = (a != b).nonzero()[0].tolist()
            raise AssertionError(f"{what}: record {name} differs first at "
                                 f"step {s} row {r}: {a[s, r].item()} != "
                                 f"{b[s, r].item()}")
    assert set(gs) == set(ws) == set(ref.SWEEP_STATE)
    for name in ref.SWEEP_STATE:
        assert gs[name].dtype == ws[name].dtype, (what, name)
        assert torch.equal(gs[name], ws[name]), (what, name, gs[name],
                                                 ws[name])


# ---------------------------------------------------------------------------
# on the CPU: the plain step
# ---------------------------------------------------------------------------
CPU_CASES = {
    "fig9_wlbvt": lambda: _seeds(_fig9("wlbvt"), 2),
    "fig9_rr": lambda: _seeds(_fig9("rr"), 2),
    "budget_kill": lambda: _seeds(_budget(), 2),
}


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_scan_is_the_plain_step(case, precision):
    """``ops.sweep_scan`` on CPU tensors launches nothing and equals the
    step with its round behind ``ops.wlbvt_select_rounds`` (how the sweep
    ran before the scan was one kernel), record for record; and
    ``devicepath``'s CPU run is those records, materialised."""
    specs = CPU_CASES[case]()
    data, kw = _geometry(specs, precision)
    ops.reset_launches()
    got = ops.sweep_scan(data, **kw)
    assert all(n == 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES
    want = ref.sweep_scan_ref(
        data, **kw, select=functools.partial(ops.wlbvt_select_rounds,
                                             impl=""))
    _assert_same(got, want, case)
    if case == "budget_kill":     # kills exercised
        assert bool((((got[1][2] >> 30) & 1) != 0).any())
    runs = DP.run_sweep_specs(specs, precision=precision,
                              record_completions=True, device="cpu")
    ftype = DP.PRECISIONS[precision]
    fin = {k: v.numpy() for k, v in got[0].items()}
    ys = tuple(y.numpy() for y in got[1])
    for r, (spec, run) in enumerate(zip(specs, runs)):
        m = DP._materialize(spec, DP._spec_arrays(spec, ftype), fin, ys, r,
                            True)
        assert m.time == run.time
        assert m.completions == run.completions
        assert m.summary_row() == run.summary_row()
        assert ([(e.tenant, e.kind, e.time) for e in m.events]
                == [(e.tenant, e.kind, e.time) for e in run.events])
        assert m.jain_pu_timeavg == run.jain_pu_timeavg


@pytest.mark.parametrize("bad", ["T129", "P129", "mixed_dtypes",
                                 "non_contiguous", "scheduler"])
def test_wrapper_rejects_before_any_launch(bad, monkeypatch):
    """The wrapper checks limits, dtypes, shapes and contiguity before it
    loads the library, so a bad call never reaches CUDA."""
    def no_lib():
        raise AssertionError("reached the kernel's library")
    monkeypatch.setattr(K, "_lib", no_lib)
    data, kw = _geometry(_seeds(_fig9(duration_us=1.0), 2))
    match = {"T129": "tenants", "P129": "PUs", "mixed_dtypes": "arr_comp",
             "non_contiguous": "contiguous", "scheduler": "schedules"}[bad]
    if bad == "T129":
        kw["T"] = 129
    elif bad == "P129":
        kw["P"] = 129
    elif bad == "mixed_dtypes":
        data["arr_comp"] = data["arr_comp"].float()
    elif bad == "non_contiguous":
        data["klim"] = torch.cat([data["klim"], data["klim"]], dim=1)[:, ::2]
        assert not data["klim"].is_contiguous()
    else:
        kw["scheduler"] = "drr"
    with pytest.raises(ValueError, match=match):
        K.sweep_scan_cuda(data, **kw)


@pytest.mark.parametrize("T,P", [(129, 32), (8, 129)])
def test_pallas_impl_keeps_the_kernel_limits_on_cpu(T, P):
    data, kw = _geometry(_seeds(_fig9(duration_us=1.0), 1))
    kw.update(T=T, P=P)
    with pytest.raises(ValueError, match="sweep_scan supports"):
        ops.sweep_scan(data, **kw, impl="pallas")
    with pytest.raises(ValueError, match="unknown wlbvt_select impl"):
        ops.sweep_scan(data, **kw, impl="triton")


def _live_steps(state, ys):
    """Each row's live steps: one event each, an arrival (``na``) or a
    completion (a record with a packet)."""
    return state["na"] + (ys[2] != -1).sum(dim=0)


@pytest.mark.parametrize("seed", range(4))
def test_dead_rows_stay_frozen(seed):
    """The invariant the kernel's early exit rests on, on the plain step:
    once a row is drained (nothing left) or its next event is past its
    horizon, every later record is one and the same dead record (no
    event, no completion, the frozen time) and the state no longer
    changes.  A seeded batch: a short row that drains early, a long row,
    and a row cut by its horizon; then the batch run only as far as the
    long row's death, so that row is live up to its last step beside the
    drained one."""
    rng = np.random.RandomState(seed)
    sched = ("wlbvt", "rr")[seed % 2]
    precision = ("exact", "fast")[(seed // 2) % 2]
    T = int(rng.randint(2, 6))
    short = _mix(T, float(rng.uniform(0.3, 0.8)), sched, (seed,))[0]
    long = _mix(T, float(rng.uniform(1.5, 2.5)), sched, (seed + 1,))[0]
    cut = dataclasses.replace(long, seed=seed + 2,
                              horizon_us=float(rng.uniform(0.6, 1.2)),
                              fifo_capacity=int(rng.randint(2, 6)))
    data, kw = _geometry([short, long, cut], precision)
    state, ys = ref.sweep_scan_ref(data, **kw)
    d = _live_steps(state, ys).tolist()
    assert d[0] < d[1] and d[2] < d[1] < kw["S"], d
    for r, dr in enumerate(d):
        eq, t, meta, kt = (y[dr:, r] for y in ys)
        assert bool((eq == eq[0]).all() and (eq[0] & 7) == 0)
        assert bool((t == state["now"][r]).all())
        assert bool((meta == -1).all() and (kt == 0).all())
        # the state at the row's death is its final state
        s_d, y_d = ref.sweep_scan_ref(data, **{**kw, "S": dr})
        for name in ref.SWEEP_STATE:
            assert torch.equal(s_d[name][r], state[name][r]), (r, name)
        for y, yd in zip(ys, y_d):
            assert torch.equal(y[:dr, r], yd[:, r]), r
    # cut at the long row's death: it is live to its last step
    s_c, y_c = ref.sweep_scan_ref(data, **{**kw, "S": d[1]})
    live = _live_steps(s_c, y_c).tolist()
    assert live[1] == d[1] and live[0] == d[0] and live[2] == d[2]
    assert bool((y_c[2][d[0]:, 0] == -1).all())


# ---------------------------------------------------------------------------
# on the card: the kernel against the plain step
# ---------------------------------------------------------------------------
GPU_CASES = {
    "fig9_wlbvt": lambda: _seeds(_fig9("wlbvt", duration_us=20.0), 3),
    "fig9_rr": lambda: _seeds(_fig9("rr", duration_us=20.0), 3),
    "fifo8_wlbvt": lambda: _seeds(_fig9("wlbvt", fifo_capacity=8), 3),
    "fifo8_rr": lambda: _seeds(_fig9("rr", fifo_capacity=8), 3),
    "budget_wlbvt": lambda: _seeds(_budget("wlbvt", 10.0), 3),
    "budget_rr": lambda: _seeds(_budget("rr", 10.0), 3),
    "horizon_wlbvt": lambda: _seeds(_fig9("wlbvt", duration_us=12.0,
                                          horizon_us=6.0), 3),
    "horizon_rr": lambda: _seeds(_fig9("rr", duration_us=12.0,
                                       horizon_us=6.0), 3),
    "mix2_wlbvt": lambda: _mix(2, 3.0, "wlbvt", range(4), 3.0,
                                fifo_capacity=6),
    "mix8_wlbvt": lambda: _mix(8, 3.0, "wlbvt", range(5), 3.0,
                                fifo_capacity=6),
    "mix8_rr": lambda: _mix(8, 3.0, "rr", range(5), 3.0, fifo_capacity=6),
    "mix33_wlbvt": lambda: _mix(33, 2.0, "wlbvt", range(3), 3.0,
                                fifo_capacity=3,
                                limits=[0, 300] * 16 + [0],
                                tlims=[0, 0, 9000] * 11),
    "mix33_rr": lambda: _mix(33, 2.0, "rr", range(3), 3.0, fifo_capacity=3,
                             limits=[0, 300] * 16 + [0],
                             tlims=[0, 0, 9000] * 11),
    "mix128_wlbvt": lambda: _mix(128, 1.5, "wlbvt", range(2), 6.0,
                                 fifo_capacity=1),
    "mix128_rr": lambda: _mix(128, 1.5, "rr", range(2), 6.0,
                              fifo_capacity=1),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _kernel_vs_plain(specs, precision, what=""):
    data, kw = _geometry(specs, precision, "cuda")
    ops.reset_launches()
    got = ops.sweep_scan(data, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sweep_scan"] == 1
    assert ops.LAUNCHES["wlbvt_select"] == 0
    want = ref.sweep_scan_ref(data, **kw, graph_steps=ref.GRAPH_STEPS)
    _assert_same(got, want, what)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_kernel_equals_plain_step(case, precision):
    _need_card()
    got = _kernel_vs_plain(GPU_CASES[case](), precision, case)
    code = got[1][0] & 7
    if case.startswith("fifo8") or case.startswith("mix"):
        assert bool((code == 2).any()) and bool((code == 1).any())
    if case.startswith("budget"):
        assert bool((code == 3).any()) and bool((code == 4).any())


@settings(max_examples=10, deadline=None)
@given(st.data())
def _random_specs_check(data):
    T = 3
    prios = [data.draw(st.floats(0.5, 4.0)) for _ in range(T)]
    slopes = [data.draw(st.floats(0.0, 0.8)) for _ in range(T)]
    limits = [data.draw(st.integers(0, 1)) * data.draw(
        st.integers(200, 2000)) for _ in range(T)]
    sched = "wlbvt" if data.draw(st.booleans()) else "rr"
    precision = "exact" if data.draw(st.booleans()) else "fast"
    tens = tuple(
        TenantSpec(f"t{i}",
                   workload=WorkloadSpec(name=f"w{i}", compute_base=40.0,
                                         compute_per_byte=slopes[i]),
                   arrival=ArrivalSpec(size=512, share=1.0 / T,
                                       seed_offset=i),
                   priority=prios[i], kernel_cycle_limit=limits[i])
        for i in range(T))
    base = ScenarioSpec(name="prop_mix", tenants=tens, duration_us=4.0,
                        scheduler=sched)
    _kernel_vs_plain(_seeds(base, 2), precision, "random")


@pytest.mark.gpu
def test_random_specs_kernel_equals_plain_step():
    """tests/test_torch_devicepath.py::test_random_sweep_parity's draws."""
    _need_card()
    _random_specs_check()


@pytest.mark.gpu
def test_cuda_tensor_never_reaches_the_plain_step():
    _need_card()
    data, kw = _geometry(_seeds(_fig9(duration_us=1.0), 2), "exact", "cuda")
    for impl in ("jnp", "jnp_ref"):
        with pytest.raises(ValueError, match="plain version"):
            ops.sweep_scan(data, **kw, impl=impl)
    ops.reset_launches()
    ops.sweep_scan(data, **kw, impl="pallas")
    assert ops.LAUNCHES["sweep_scan"] == 1
