"""The port's device telemetry backend (``Telemetry(backend="torch")``,
the ``*_torch`` kernels of ``telemetry/metrics.py``) against the JAX
package's ``"jnp"`` and ``"numpy"`` backends, ``tenant_report(signals=...)``
and ``launch/telemetry_report.py`` against the reference's, and the
serving engine with every plane on (the flight recorder, the bus with
both exporters, the ``"torch"`` backend) over a smoke-size
``ModelExecutor`` under ``pallas``.

The torch backend commits what the jnp backend commits: int32 counts and
histogram equal, and an fp32 ring equal to jnp's (both are fp32 casts of
the same float64 gauges) and within the reference's ``rtol = atol =
1e-6`` of numpy's.  ``bucket_index_torch`` in fp32 must put the exact
powers of two in their own bucket.  On the CPU the state is CPU tensors;
the ``gpu`` case holds the state on the card and runs every commit
under ``torch.cuda.set_sync_debug_mode("error")``.  The JAX legs skip
where JAX is missing (the card's machine).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core.slo import SLOPolicy
from repro_torch.serving.engine import Engine, EngineConfig, NullExecutor
from repro_torch.serving.request import Request
from repro_torch.telemetry import GAUGES, Telemetry
from repro_torch.telemetry import metrics as M

LAT_POOL = [3.0, 5.0, 7.0, 12.0, 50.0, 100.0, 999.0, 12345.0]
try:
    import jax  # noqa: F401  (the JAX legs run only beside JAX)
    HAVE_JAX = True
except ImportError:
    HAVE_JAX = False
POW2 = 2.0 ** np.arange(0, 34)


class CpuNullExecutor(NullExecutor):
    """The scheduling-only executor on the CPU: where a ``"torch"``
    telemetry backend keeps its state (the executor's device)."""
    device = torch.device("cpu")


def _stage(tels, steps=12, T=6, fractional=False):
    """The reference's wrapper-parity sequence, committed into each of
    ``tels``; ``fractional`` adds non-integer gauges (fp32 rounding)."""
    for step in range(steps):
        g = np.full((len(GAUGES), T), float(step))
        if fractional:
            g = g / 7.0 + np.arange(T) / 3.0
        for tel in tels:
            rng = np.random.RandomState(100 + step)
            for t in range(T):
                for _ in range(rng.randint(0, 3)):
                    tel.inc("arrivals", t)
                    tel.lat(t, LAT_POOL[rng.randint(0, len(LAT_POOL))])
                tel.inc("tokens", t, float(rng.randint(0, 64)))
            tel.lat(step % T, POW2[step])       # an exact bucket edge
            tel.commit()
            tel.commit_window(g)


def _assert_state(got, jnp_snap, np_snap):
    for k in ("counts", "hist", "ptr"):
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], np_snap[k], err_msg=k)
        if jnp_snap is not None:
            np.testing.assert_array_equal(got[k], jnp_snap[k], err_msg=k)
    assert got["ring"].dtype == np.float32
    np.testing.assert_allclose(got["ring"], np_snap["ring"], rtol=1e-6,
                               atol=1e-6)
    if jnp_snap is not None:
        np.testing.assert_array_equal(got["ring"], jnp_snap["ring"])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def test_bucket_index_torch_holds_the_powers_of_two():
    vals = np.concatenate([POW2, np.nextafter(POW2, 0), POW2 * 1.5,
                           [0.0, 0.5, 1e12]])
    got = M.bucket_index_torch(torch.from_numpy(vals), 32).numpy()
    want = M.bucket_index(vals, 32, np)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:32], np.arange(32))


def test_bucket_index_torch_equals_jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.telemetry.metrics import bucket_index as jax_bucket_index
    rng = np.random.default_rng(0)
    vals = np.concatenate([POW2, np.arange(1.0, 5000.0),
                           rng.lognormal(7.0, 3.0, 20000)])
    got = M.bucket_index_torch(torch.from_numpy(vals), 32).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jax_bucket_index(vals, 32, jnp)))


def test_record_kernels_equal_jnp_and_numpy():
    """The reference's kernel-level parity sequence through
    ``record_step_torch`` / ``record_window_torch``."""
    rng = np.random.RandomState(1)
    T = 8
    st_t = M.create_state_torch(T, device="cpu")
    st_np = M.create_state(T, xp=np)
    seq = []
    for _ in range(20):
        ci = rng.randint(0, 5, size=(T, len(M.COUNTERS))).astype(float)
        vals = np.array([LAT_POOL[i]
                         for i in rng.randint(0, len(LAT_POOL), T)])
        mask = rng.rand(T) < 0.6
        g = rng.randint(0, 100, size=(len(GAUGES), T)).astype(float)
        seq.append((ci, vals, mask, g))
        st_t = M.record_step_torch(st_t, torch.tensor(ci, dtype=torch.float32),
                                   torch.tensor(vals, dtype=torch.float32),
                                   torch.from_numpy(mask))
        st_t = M.record_window_torch(st_t, torch.tensor(g,
                                                        dtype=torch.float32))
        st_np = M.record_step(st_np, ci, vals, mask, np)
        st_np = M.record_window(st_np, g, np)
    got = {k: v.numpy() for k, v in st_t.items()}
    jnp_snap = None
    if HAVE_JAX:
        import jax.numpy as jnp
        from repro.telemetry import metrics as JM
        st_j = JM.create_state(T, xp=jnp)
        step_j = jax.jit(lambda s, c, v, m: JM.record_step(s, c, v, m, jnp))
        win_j = jax.jit(lambda s, g: JM.record_window(s, g, jnp))
        for ci, vals, mask, g in seq:
            st_j = win_j(step_j(st_j, ci, vals, mask), g)
        jnp_snap = {k: np.asarray(v) for k, v in st_j.items()}
    _assert_state(got, jnp_snap, st_np)


# ---------------------------------------------------------------------------
# the staging wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fractional", [False, True],
                         ids=["integer-gauges", "fractional-gauges"])
def test_wrapper_torch_equals_jnp_and_numpy(fractional):
    tels = [Telemetry(6, backend="torch", device="cpu"), Telemetry(6)]
    if HAVE_JAX:
        from repro.telemetry import Telemetry as JaxTelemetry
        tels.append(JaxTelemetry(6, backend="jnp"))
    _stage(tels, fractional=fractional)
    snaps = [t.snapshot() for t in tels]
    _assert_state(snaps[0], snaps[2] if len(snaps) > 2 else None, snaps[1])
    assert tels[0].state["counts"].device.type == "cpu"


def test_wrapper_reset_tenant_and_staged():
    tel, ref = Telemetry(4, backend="torch", device="cpu"), Telemetry(4)
    _stage((tel, ref), steps=5, T=4)
    for t in (tel, ref):
        t.inc("arrivals", 2, 3.0)
        t.lat(2, 40.0)
        t.reset_tenant(2)
        assert t.staged("arrivals")[2] == 0.0
        t.inc("arrivals", 1, 2.0)
        t.commit()
    a, b = tel.snapshot(), ref.snapshot()
    for k in ("counts", "hist", "ptr"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not a["hist"][2].any() and not a["ring"][:, 2].any()
    np.testing.assert_allclose(a["ring"], b["ring"], rtol=1e-6, atol=1e-6)
    assert tel.counter("arrivals")[1] == ref.counter("arrivals")[1]


def test_backends_refuse_what_they_cannot_do():
    with pytest.raises(ValueError, match="unknown telemetry backend"):
        Telemetry(2, backend="jnp")
    if not torch.cuda.is_available():
        # no device helper falls back: the card is the default
        with pytest.raises((RuntimeError, AssertionError)):
            Telemetry(2, backend="torch")
        with pytest.raises((RuntimeError, AssertionError)):
            Engine(EngineConfig(max_tenants=2, telemetry_backend="torch"))


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def _engine_snapshot(backend, make_engine, make_request):
    eng = make_engine(backend)
    for t in range(2):
        eng.create_ectx(t, SLOPolicy(kv_quota_tokens=128 * 4))
    rng = np.random.RandomState(0)
    for i in range(12):
        t = i % 2
        plen = 40 if t == 0 else 8
        eng.submit(make_request(t, rng.randint(1, 90, plen).astype(np.int32),
                                max_new_tokens=16 if t == 0 else 4))
    eng.run_until_idle()
    return eng.tel.snapshot()


def test_engine_telemetry_torch_equals_jnp_and_numpy():
    """The serving engine commits the same telemetry on the torch
    backend (the executor's device: the CPU here) as on jnp and numpy."""
    ecfg = dict(max_slots=4, max_len=128, prefill_chunk=32, max_tenants=4,
                kv_overcommit=2.0)

    def port(backend):
        cfg = EngineConfig(**ecfg, telemetry_backend=backend)
        return Engine(cfg, CpuNullExecutor(cfg))

    got = _engine_snapshot("torch", port, Request)
    want = _engine_snapshot("numpy", port, Request)
    jnp_snap = None
    if HAVE_JAX:
        from repro.serving.engine import Engine as JaxEngine
        from repro.serving.engine import EngineConfig as JaxEngineConfig
        from repro.serving.request import Request as JaxRequest
        jnp_snap = _engine_snapshot(
            "jnp", lambda b: JaxEngine(JaxEngineConfig(
                **ecfg, telemetry_backend=b)), JaxRequest)
    _assert_state(got, jnp_snap, want)
    assert got["hist"].sum() == 12


# ---------------------------------------------------------------------------
# tenant_report(signals=...) and the telemetry report CLI
# ---------------------------------------------------------------------------
def test_tenant_report_signals_equal_the_reference():
    pytest.importorskip("jax")
    from repro.telemetry import Telemetry as JaxTelemetry
    from repro.telemetry import compute_signals as jax_compute_signals
    from repro.telemetry import tenant_report as jax_tenant_report
    from repro_torch.telemetry import compute_signals, tenant_report
    tel, jtel = Telemetry(4), JaxTelemetry(4)
    _stage((tel, jtel), steps=6, T=4, fractional=True)
    kw = dict(prio=np.array([1.0, 2.0, 1.0, 3.0]),
              total_occup=np.array([10.0, 4.0, 7.0, 1.0]),
              bvt=np.array([3.0, 2.0, 5.0, 1.0]),
              kv_pressure=np.array([0.1, 0.5, 0.0, 0.9]))
    names = {0: "a", 1: "b"}
    got = tenant_report(tel, names=names,
                        signals=compute_signals(tel, **kw))
    want = jax_tenant_report(jtel, names=names,
                             signals=jax_compute_signals(jtel, **kw))
    assert "jain_weighted" in got and "service_debt" in got["tenants"][1]
    assert json.dumps(got) == json.dumps(want)
    assert json.dumps(tenant_report(tel)) == \
        json.dumps(jax_tenant_report(jtel))


@pytest.mark.parametrize("argv", [
    ["--surface", "sim", "--controller", "--duration-us", "60"],
    ["--surface", "serving", "--controller"]], ids=["sim", "serving"])
def test_telemetry_report_cli_equals_the_reference(tmp_path, capsys, argv):
    from repro_torch.launch import telemetry_report as cli
    assert cli.main(argv + ["--json", str(tmp_path / "port.json")]) == 0
    out = capsys.readouterr().out
    assert "controller=True" in out
    pytest.importorskip("jax")
    from repro.launch import telemetry_report as jax_cli
    assert jax_cli.main(argv + ["--json", str(tmp_path / "ref.json")]) == 0
    assert capsys.readouterr().out.replace("ref.json", "port.json") == out
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


# ---------------------------------------------------------------------------
# every plane on over a real (smoke-size) model
# ---------------------------------------------------------------------------
SERVE_KW = dict(tenants=3, requests=6, max_len=64, prefill_chunk=16)


def _planes_run(api, executor, prefix, **cfg):
    """``serve_mixed_slo`` with the flight recorder and a bus carrying
    both exporters; returns the report, its runtime and the exports."""
    from importlib import import_module
    bus_mod = import_module(f"{api}.telemetry.bus")
    export = import_module(f"{api}.telemetry.export")
    get_scenario = import_module(f"{api}.api").get_scenario
    ServeRuntime = import_module(f"{api}.api").ServeRuntime
    spec = get_scenario("serve_mixed_slo", **SERVE_KW,
                        vocab=cfg.pop("vocab"))
    rt = ServeRuntime.from_spec(spec, executor=executor, **cfg)
    bus = None
    if prefix:
        bus = bus_mod.MetricsBus()
        export.attach_exporters(bus, prefix, names={
            i: t.name for i, t in enumerate(spec.tenants)})
        rt.attach_bus(bus)
    rep = rt.run(spec).validate()
    if bus is not None:
        bus.close()
        rt.flush_trace()
    return rep, rt


def test_model_executor_planes_equal_the_reference(tmp_path):
    """Qwen3's float32 smoke model, the port under ``pallas`` (the
    kernels' plain versions on the CPU) with the reference's weights:
    with every plane on, the RunReport JSON, the span and decision rows,
    the Perfetto JSON, every JSONL frame and the OpenMetrics text equal
    the JAX package's (its ``jnp`` backend; the report names the
    backend, so that one label differs).  The planes change nothing
    else: the report without ``trace_summary`` equals the planes-off
    run's, and the telemetry equals the numpy backend's."""
    jax = pytest.importorskip("jax")
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.serving.engine import ModelExecutor as JaxModelExecutor
    from repro.telemetry.traceview import to_perfetto as jax_to_perfetto
    from repro_torch.api import RunReport
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import ModelExecutor
    from repro_torch.telemetry.traceview import to_perfetto
    from repro_torch.weights import params_from_jax
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-8b"), dtype="float32")
    tcfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                               attn_impl="pallas")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    module = params_from_jax(jax.tree.map(np.asarray, params), tcfg)

    def port_exe(e):
        return ModelExecutor(tcfg, e, params=module, device="cpu")

    on = dict(trace=True, vocab=jcfg.vocab_size)
    rep, rt = _planes_run("repro_torch", port_exe,
                          str(tmp_path / "port"), telemetry_backend="torch",
                          **on)
    jrep, jrt = _planes_run(
        "repro", lambda e: JaxModelExecutor(jcfg, e, params=params),
        str(tmp_path / "ref"), telemetry_backend="jnp", **on)
    assert rep.to_json() == jrep.to_json().replace('"backend": "jnp"',
                                                   '"backend": "torch"')
    for k, v in rt.trace.rows().items():
        np.testing.assert_array_equal(v, jrt.trace.rows()[k], err_msg=k)
    for k, v in rt.trace.decision_rows().items():
        np.testing.assert_array_equal(v, jrt.trace.decision_rows()[k],
                                      err_msg=k)
    assert json.dumps(to_perfetto(rt.trace, time_unit="steps")) == \
        json.dumps(jax_to_perfetto(jrt.trace, time_unit="steps"))
    for ext in ("om.txt", "jsonl"):
        port = (tmp_path / f"port.{ext}").read_bytes()
        assert port and port == (tmp_path / f"ref.{ext}").read_bytes(), ext
    snap = rt.engine.tel.snapshot()
    off, rt_off = _planes_run("repro_torch", port_exe, "",
                              vocab=jcfg.vocab_size)
    stripped = RunReport.from_json(rep.to_json())
    del stripped.extras["trace_summary"]
    assert stripped.to_json() == off.to_json().replace(
        '"backend": "numpy"', '"backend": "torch"')
    _assert_state(snap, jrt.engine.tel.snapshot(),
                  rt_off.engine.tel.snapshot())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_device_state_commits_without_a_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the state lives on the card")
    tel, ref = Telemetry(6, backend="torch"), Telemetry(6)
    assert tel.state["hist"].device.type == "cuda"
    commit, window = tel.commit, tel.commit_window

    def no_sync(fn):
        def call(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    tel.commit, tel.commit_window = no_sync(commit), no_sync(window)
    _stage((tel, ref), fractional=True)
    got = tel.snapshot()
    _assert_state(got, None, ref.snapshot())
    edges = M.bucket_index_torch(torch.tensor(POW2, device="cuda"), 32)
    np.testing.assert_array_equal(edges.cpu().numpy(),
                                  M.bucket_index(POW2, 32, np))
