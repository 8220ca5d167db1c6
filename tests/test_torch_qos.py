"""The port's closed-loop QoS plane against the JAX package: the signals
(``telemetry/signals.py``), the AIMD controller
(``telemetry/controller.py``), the SLO burn-rate audit
(``telemetry/slo_audit.py``), their hooks in ``core/engine_base.py``
and the serving engine, and the tensor twins of the WLBVT/DWRR scheduler
(``core/wlbvt.py``'s ``*_torch``, the reference's ``*_jnp``).

All of the plane is host numpy in both packages, so the signals, the
actions, the alerts and the ``qos_closed_loop`` RunReports (sim on both
datapaths, serve with the NullExecutor, ``extras["slo_audit"]``
included) are equal exactly.  The torch scheduler functions run float32
/ int32 as the jnp ones do, on integral inputs where every value is
exact, so they equal both the jnp functions and the float64 numpy
wrappers.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import telemetry as JT  # noqa: E402
from repro.api import get_scenario as jax_get_scenario  # noqa: E402
from repro.api import run_scenario as jax_run_scenario  # noqa: E402
from repro.core import wlbvt as JW  # noqa: E402
from repro_torch import telemetry as T  # noqa: E402
from repro_torch.api import get_scenario, run_scenario  # noqa: E402
from repro_torch.core import wlbvt as W  # noqa: E402

NT = 4   # tenants


def _telemetry_pair(seed: int):
    """The same staged counters, latencies and gauge windows, committed
    in both packages' ``Telemetry``."""
    rng = np.random.default_rng(seed)
    pair = (T.Telemetry(NT), JT.Telemetry(NT))
    for _ in range(12):
        incs = [(str(rng.choice(["arrivals", "completed", "drops",
                                 "ecn_marks", "bytes_in"])),
                 int(rng.integers(NT)), float(rng.integers(1, 5)))
                for _ in range(20)]
        lats = [(int(rng.integers(NT)), float(rng.lognormal(7.0, 1.0)))
                for _ in range(15)]
        gauges = rng.integers(0, 8, (len(T.GAUGES), NT)).astype(float)
        for tel in pair:
            for name, t, v in incs:
                tel.inc(name, t, v)
            for t, v in lats:
                tel.lat(t, v)
            tel.commit()
            tel.commit_window(gauges)
    return pair


def _sched_arrays(seed: int):
    rng = np.random.default_rng(seed + 100)
    return dict(prio=rng.integers(1, 4, NT).astype(float),
                total_occup=rng.integers(0, 500, NT).astype(float),
                bvt=np.array([0.0, 40.0, 90.0, 7.0]),
                kv_pressure=rng.random(NT))


def _frames_equal(a, b):
    da, db = a.as_dict(), b.as_dict()
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]),
                                      err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signals_equal_reference(seed):
    port, ref = _telemetry_pair(seed)
    kw = _sched_arrays(seed)
    _frames_equal(T.compute_signals(port, **kw),
                  JT.compute_signals(ref, **kw))
    # interval form: differenced against an earlier snapshot
    base_p, base_r = port.snapshot(), ref.snapshot()
    for tel in (port, ref):
        tel.inc("arrivals", 1, 3.0)
        tel.lat(1, 5000.0)
        tel.commit()
    _frames_equal(T.compute_signals(port, baseline=base_p, **kw),
                  JT.compute_signals(ref, baseline=base_r, **kw))
    np.testing.assert_array_equal(
        T.wlbvt_service_debt(kw["total_occup"], kw["bvt"], kw["prio"]),
        JT.wlbvt_service_debt(kw["total_occup"], kw["bvt"], kw["prio"]))


def _frame(mod, rng, p99_scale):
    return mod.SignalFrame(
        p50=rng.random(NT) * p99_scale / 2, p99=rng.random(NT) * p99_scale,
        ecn_rate=rng.random(NT), drop_rate=rng.random(NT) * 0.5,
        service_debt=rng.standard_normal(NT), kv_pressure=rng.random(NT),
        occupancy_mean=rng.random(NT), queue_mean=rng.random(NT),
        jain_weighted=float(rng.random()),
        lat_samples=rng.integers(0, 3, NT).astype(float))


def test_controller_and_audit_equal_reference():
    """One AIMD controller and one SLO audit per package over the same
    40 frames: equal actions, live weights, alerts, interventions and
    summaries."""
    base = np.array([1.0, 2.0, 1.0, 3.0])
    targets = [2000.0, 0.0, 3000.0, 1500.0]
    cp, cr = (T.QoSController(base, p99_targets=targets),
              JT.QoSController(base, p99_targets=targets))
    cfg = dict(objective=0.9, fast_windows=2, slow_windows=6,
               fast_burn=4.0, slow_burn=2.0)
    ap = T.SLOAudit(targets, config=T.SLOAuditConfig(**cfg))
    ar = JT.SLOAudit(targets, config=JT.SLOAuditConfig(**cfg))
    live_p, live_r = base.copy(), base.copy()
    counts = np.zeros((NT, len(T.COUNTERS)))
    rp, rr = np.random.default_rng(7), np.random.default_rng(7)
    for k in range(40):
        fp = _frame(T, rp, 4000.0 if k % 10 < 6 else 1000.0)
        fr = _frame(JT, rr, 4000.0 if k % 10 < 6 else 1000.0)
        counts[:, T.C_IDX["arrivals"]] = k % 3
        counts[:, T.C_IDX["completed"]] = k % 2
        t = 1000.0 * (k + 1)
        alp = ap.observe(t=t, sig=fp, interval_counts=counts)
        alr = ar.observe(t=t, sig=fr, interval_counts=counts)
        assert ([dataclasses.astuple(a) for a in alp]
                == [dataclasses.astuple(a) for a in alr])
        xp, xr = cp.update(fp), cr.update(fr)
        for f in ("weights", "boost", "admit", "violating"):
            np.testing.assert_array_equal(getattr(xp, f), getattr(xr, f))
        assert ap.note_intervention(t, xp) == ar.note_intervention(t, xr)
        T.apply_to_scheduler(xp, (live_p, base))
        JT.apply_to_scheduler(xr, (live_r, base))
        np.testing.assert_array_equal(live_p, live_r)
    sp, sr = ap.summary(), ar.summary()
    assert json.dumps(sp, sort_keys=True) == json.dumps(sr, sort_keys=True)
    assert sp["alerts_total"] and sp["interventions_total"]
    cp.reset_tenant(0, base_weight=1.0)
    cr.reset_tenant(0, base_weight=1.0)
    np.testing.assert_array_equal(cp.weights, cr.weights)


@pytest.mark.parametrize("backend,datapath", [
    ("sim", "event"), ("sim", "batched"), ("serve", "event")])
def test_qos_closed_loop_report_equals_reference(backend, datapath):
    """The controller and the auto-attached SLO audit on each backend:
    the whole RunReport, ``extras["slo_audit"]`` included, byte for
    byte."""
    kw = dict(duration_us=40.0) if backend == "sim" else {}
    spec = get_scenario("qos_closed_loop", **kw).replace(datapath=datapath)
    ref = jax_get_scenario("qos_closed_loop", **kw).replace(
        datapath=datapath)
    port, want = run_scenario(spec, backend), jax_run_scenario(ref, backend)
    assert (json.dumps(port.to_dict(), sort_keys=True)
            == json.dumps(want.to_dict(), sort_keys=True))
    audit = port.extras["slo_audit"]
    assert audit["intervals"] > 0 and audit["interventions_total"] > 0


def test_serve_controller_moves_weights_and_resets_on_destroy():
    from repro_torch.core.slo import SLOPolicy
    from repro_torch.serving.engine import Engine, EngineConfig
    eng = Engine(EngineConfig(max_slots=4, max_len=64, prefill_chunk=16,
                              max_tenants=2, qos_interval=2))
    for t in (0, 1):
        eng.create_ectx(t, SLOPolicy(priority=1.0, kv_quota_tokens=128))
    ctl = T.QoSController(np.ones(2), p99_targets=[1.0, 0.0])
    eng.attach_controller(ctl)
    from repro_torch.serving.request import Request
    for _ in range(6):
        for t in (0, 1):
            eng.submit(Request(t, np.ones(8, np.int32), max_new_tokens=4))
    eng.run_until_idle()
    assert ctl.history and ctl.weights[0] > 1.0    # violating tenant 0
    eng.destroy_ectx(0)
    assert ctl.weights[0] == 1.0 and not ctl.paused[0]
    with pytest.raises(ValueError, match="qos_interval"):
        Engine(EngineConfig(max_tenants=2)).attach_controller(ctl)
    from repro_torch.telemetry.bus import MetricsBus
    bus = MetricsBus()
    eng.attach_bus(bus)              # the bus plane is ported: it attaches
    assert eng.bus is bus


# ---------------------------------------------------------------------------
# the tensor scheduler surface against *_jnp and the numpy wrappers
# ---------------------------------------------------------------------------
def _states(rng):
    n = int(rng.integers(2, 9))
    prio = rng.integers(1, 5, n).astype(float)
    vals = dict(queue_len=rng.integers(0, 6, n),
                cur_occup=rng.integers(0, 4, n),
                total_occup=rng.integers(0, 100, n).astype(float),
                bvt=rng.integers(0, 50, n).astype(float))
    st, sj = (W.init_state_torch(prio, device="cpu"),
              JW.init_state_jnp(prio))
    sn = JW.WLBVTState.create(prio)
    for k, v in vals.items():
        st[k] = torch.as_tensor(v, dtype=st[k].dtype)
        sj[k] = jax.numpy.asarray(v, sj[k].dtype)
        getattr(sn, k)[:] = v
    return n, st, sj, sn


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(4))
def test_wlbvt_torch_equals_jnp_and_numpy(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n, st, sj, sn = _states(rng)
        st, sj = W.advance_torch(st, 3.0), JW.advance_jnp(sj, 3.0)
        JW.advance(sn, 3.0)
        for k in st:
            _same(st[k], sj[k])
            np.testing.assert_array_equal(st[k].numpy(), getattr(sn, k))
        _same(W.pu_limit_torch(st, 8), JW.pu_limit_jnp(sj, 8))
        np.testing.assert_array_equal(W.pu_limit_torch(st, 8).numpy(),
                                      JW.pu_limit(sn, 8))
        assert (int(W.select_torch(st, 8)) == int(JW.select_jnp(sj, 8))
                == JW.select(sn, 8))
        cap = rng.integers(1, 5, n) if rng.random() < 0.5 else None
        pt, nt = W.select_k_torch(st, 8, 6, cap=cap)
        pj, nj = JW.select_k_jnp(sj, 8, 6, cap=cap)
        pn = JW.select_k(sn, 8, 6, cap=cap)
        _same(pt, pj)
        np.testing.assert_array_equal(pt.numpy(), pn)
        assert pt.dtype == torch.int32
        for k in nt:
            _same(nt[k], nj[k])
        np.testing.assert_array_equal(nt["queue_len"].numpy(), sn.queue_len)


@pytest.mark.parametrize("seed", range(3))
def test_dwrr_torch_equals_jnp_and_numpy(seed):
    rng = np.random.default_rng(seed)
    n = 5
    w = rng.integers(1, 4, n).astype(float)
    st, sj = W.dwrr_state_torch(w, device="cpu"), JW.dwrr_state_jnp(w)
    sn = JW.DWRRState.create(w)
    for _ in range(40):
        head = rng.integers(0, 3000, n).astype(float)
        pending = rng.random(n) < 0.6
        it, st = W.dwrr_select_torch(st, head, pending, 512.0)
        ij, sj = JW.dwrr_select_jnp(sj, head, pending, 512.0)
        assert int(it) == int(ij) == JW.dwrr_select(sn, head, pending,
                                                    512.0)
        for k in st:
            _same(st[k], sj[k])
        np.testing.assert_array_equal(st["deficit"].numpy(),
                                      sn.deficit.astype(np.float32))


def test_torch_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        W.init_state_torch([1.0, 2.0])
