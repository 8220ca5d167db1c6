"""The port's trace plane (``telemetry/trace.py``, ``telemetry/traceview.py``,
``launch/trace.py`` and the hooks in the three engines) against the JAX
package's.

The recorder's own properties are held on the port alone: ring eviction
keeps lifecycles paired, ``tail`` is a suffix of ``rows``, the WLBVT
replay equals a sequential replay with the scheduler's formulas, span
sums reconcile with completion latency, the Perfetto export's schema and
its ``--last`` suffix.  Then the same specs and seeds go through both
packages: the span rows, the decision rows, ``tail(n)``,
``trace_summary()``, the Perfetto JSON and the ``RunReport`` JSON must be
equal byte for byte on both sim datapaths (fig9 and qos_closed_loop) and
on the serve backend (``NullExecutor``).  Tracing on changes no reported
metric.  The JAX legs skip where JAX is missing (the card's machine).
"""
import json
from collections import Counter

import numpy as np
import pytest

from repro_torch.core import sched_generic as G
from repro_torch.core import wlbvt as W
from repro_torch.telemetry import trace as TR
from repro_torch.telemetry.trace import TraceRecorder, record_wlbvt_round
from repro_torch.telemetry.traceview import (PID_PU, PID_SCHED, PID_TENANTS,
                                             to_perfetto)

FULL_LIFECYCLE = (TR.ST_ARRIVE, TR.ST_FMQ, TR.ST_GRANT, TR.ST_PU,
                  TR.ST_DMA, TR.ST_EQ)
DROP_UID_BASE = 1_000_000
SIM_CASES = [("fig9_congestor_victim", "event"),
             ("fig9_congestor_victim", "batched"),
             ("qos_closed_loop", "event"),
             ("qos_closed_loop", "batched")]


def _flood(tr, n):
    """n packet lifecycles (6 rows each) with an eager drop row every
    10th packet, so packet records and plain rows interleave."""
    for i in range(n):
        t = float(i)
        tr.span_packet(i, i % 3, i % 4, TR.D_OK, TR.D_OK,
                       t, t + 1.0, t + 2.0, t + 2.5)
        if i % 10 == 9:
            tr.span(TR.ST_ARRIVE, DROP_UID_BASE + i, i % 3,
                    t + 0.5, t + 0.5, TR.D_DROP)


def _by_uid(rows):
    per = {}
    for uid, stage in zip(rows["uid"].tolist(), rows["stage"].tolist()):
        per.setdefault(uid, []).append(stage)
    return per


def _assert_cols_equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}.{k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}.{k}")


# ---------------------------------------------------------------------------
# the recorder alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("commit_every", [7, None],
                         ids=["incremental", "one-big-commit"])
def test_ring_eviction_keeps_lifecycles_paired(commit_every):
    depth = 64
    tr = TraceRecorder(3, depth=depth, decision_depth=16)
    ref = TraceRecorder(3, depth=1 << 16, decision_depth=16)
    n = 50
    for i in range(n):
        for rec in (tr, ref):
            t = float(i)
            rec.span_packet(i, i % 3, i % 4, TR.D_OK, TR.D_OK,
                            t, t + 1.0, t + 2.0, t + 2.5)
            if i % 10 == 9:
                rec.span(TR.ST_ARRIVE, DROP_UID_BASE + i, i % 3,
                         t + 0.5, t + 0.5, TR.D_DROP)
        if commit_every and i % commit_every == 0:
            tr.commit()
    rows = tr.rows()
    total = n * 6 + n // 10
    assert tr.span_count == total
    assert len(rows["uid"]) == depth
    full = ref.rows()
    for k in rows:
        np.testing.assert_array_equal(rows[k], full[k][total - depth:],
                                      err_msg=k)
    assert not np.any(rows["disp"] == TR.D_OPEN)
    assert np.all(rows["t1"] >= rows["t0"])
    per = _by_uid(rows)
    partial = []
    for uid, stages in per.items():
        if uid >= DROP_UID_BASE:
            assert stages == [TR.ST_ARRIVE]
            continue
        k = len(stages)
        assert tuple(stages) == FULL_LIFECYCLE[6 - k:], uid
        if k < 6:
            partial.append(uid)
    assert len(partial) <= 1
    if partial:
        assert partial[0] == min(u for u in per if u < DROP_UID_BASE)


def test_tail_matches_rows_suffix():
    tr = TraceRecorder(3, depth=128, decision_depth=16)
    _flood(tr, 40)
    rows = tr.rows()
    m = len(rows["uid"])
    for n in (0, 1, 10, m, m + 50):
        t = tr.tail(n)
        k = min(n, m)
        for c in rows:
            np.testing.assert_array_equal(t[c], rows[c][m - k:],
                                          err_msg=f"tail({n}).{c}")


def test_recorder_rows_match_the_reference_recorder():
    """The same staged rows (packet records, plain rows, decisions) in
    both packages' recorders give equal rings, evictions included."""
    pytest.importorskip("jax")
    from repro.telemetry import trace as JTR
    pair = (TraceRecorder(3, depth=100, decision_depth=8),
            JTR.TraceRecorder(3, depth=100, decision_depth=8))
    for tr, mod in zip(pair, (TR, JTR)):
        _flood(tr, 40)
        for i in range(12):
            mod.record_admission_reject(tr, float(i), i % 3)
            mod.record_slo_alert(tr, float(i), i % 3,
                                 "fast" if i % 2 else "slow", 2.5 * i)
    for n in (0, 7, 1000):
        _assert_cols_equal(pair[0].tail(n), pair[1].tail(n), f"tail({n})")
    _assert_cols_equal(pair[0].rows(), pair[1].rows(), "rows")
    _assert_cols_equal(pair[0].decision_rows(), pair[1].decision_rows(),
                       "decision_rows")
    assert json.dumps(pair[0].trace_summary()) == \
        json.dumps(pair[1].trace_summary())


def _reference_round(pre, picks, num_pus, cap):
    """Replay one round pick by pick from the pre-round state with the
    scheduler's own formulas (``sched_generic``)."""
    ql = pre["queue_len"].copy()
    co = pre["cur_occup"].copy()
    prio = pre["prio"]
    metric = G.tput(pre["total_occup"], pre["bvt"], np) / prio
    out = []
    for p in picks:
        limit = G.pu_limit(prio, ql, num_pus, np)
        elig = (ql > 0) & (co < limit)
        if cap is not None:
            elig = elig & (co < cap)
        ne = int(elig.sum())
        pmax = np.where(elig, prio, -np.inf).max()
        reason = (TR.R_FORCED_SINGLE if ne <= 1 else
                  TR.R_PRIORITY if prio[p] >= pmax else TR.R_DEBT)
        out.append((p, reason, ne, float(metric[p]), elig.copy(),
                    pre["bvt"].copy()))
        ql[p] -= 1
        co[p] += 1
    return out


def test_wlbvt_replay_matches_sequential_reference():
    rng = np.random.RandomState(7)
    for trial in range(30):
        T = int(rng.randint(2, 6))
        num_pus = int(rng.randint(2, 33))
        cap = (rng.randint(1, 6, T).astype(np.float64)
               if trial % 3 == 0 else None)
        tr = TraceRecorder(T)
        st = W.WLBVTState.create(rng.uniform(0.5, 4.0, T))
        st.queue_len[:] = rng.randint(0, 8, T)
        st.cur_occup[:] = rng.randint(0, 3, T)
        st.total_occup[:] = rng.uniform(0.0, 50.0, T)
        st.bvt[:] = rng.uniform(0.0, 30.0, T)
        refs = []
        for rnd in range(int(rng.randint(1, 6))):
            pre = {f: getattr(st, f).copy() for f in
                   ("prio", "queue_len", "cur_occup", "total_occup",
                    "bvt")}
            k = int(rng.randint(1, num_pus + 1))
            picks = [int(p) for p in W.select_k(st, num_pus, k, cap=cap)
                     if p >= 0]
            record_wlbvt_round(tr, float(rnd), st, picks, num_pus,
                               TR.K_PU_WLBVT, cap=cap)
            refs.extend(_reference_round(pre, picks, num_pus, cap))
            st.queue_len += rng.randint(0, 4, T)
            done = np.minimum(st.cur_occup, rng.randint(0, 3, T))
            st.cur_occup -= done
            W.advance(st, float(rng.uniform(0.0, 5.0)))
        d = tr.decision_rows()
        assert len(d["time"]) == len(refs), (trial, T, num_pus)
        assert np.all(d["kind"] == TR.K_PU_WLBVT)
        for i, (p, reason, ne, met, elig, bvt) in enumerate(refs):
            ctx = (trial, i)
            assert int(d["winner"][i]) == p, ctx
            assert int(d["reason"][i]) == reason, ctx
            assert int(d["n_elig"][i]) == ne, ctx
            assert d["metric"][i] == pytest.approx(met), ctx
            np.testing.assert_array_equal(d["elig"][i], elig,
                                          err_msg=str(ctx))
            np.testing.assert_allclose(d["snapshot"][i],
                                       bvt.astype(np.float32),
                                       err_msg=str(ctx))


# ---------------------------------------------------------------------------
# end to end on the simulators
# ---------------------------------------------------------------------------
def _spec(get_scenario, name, duration_us=20.0):
    spec = get_scenario(name)
    kw = {"duration_us": duration_us}
    if spec.horizon_us:
        kw["horizon_us"] = duration_us
    return spec.replace(**kw)


def _traced_run(spec, datapath, make_runtime):
    rt = make_runtime(spec, "sim", trace=True, datapath=datapath)
    rep = rt.run(spec)
    rt.flush_trace()
    return rep, rt.trace


_PORT_RUNS = {}


def _port_run(name, datapath):
    """One traced port run per (scenario, datapath), shared by the tests
    of this module."""
    key = (name, datapath)
    if key not in _PORT_RUNS:
        from repro_torch.api import get_scenario
        from repro_torch.api.runtime import make_runtime
        _PORT_RUNS[key] = _traced_run(_spec(get_scenario, name), datapath,
                                      make_runtime)
    return _PORT_RUNS[key]


def _reconcile(rows):
    """max |(FMQ+PU+DMA durations) - (EQ.t1 - ARRIVE.t0)| per packet."""
    uids, inv = np.unique(rows["uid"], return_inverse=True)
    n = len(uids)
    dur = rows["t1"] - rows["t0"]
    staged = np.isin(rows["stage"], (TR.ST_FMQ, TR.ST_PU, TR.ST_DMA))
    sums = np.bincount(inv, np.where(staged, dur, 0.0), minlength=n)
    t_arr = np.full(n, np.nan)
    t_eq = np.full(n, np.nan)
    am = rows["stage"] == TR.ST_ARRIVE
    em = rows["stage"] == TR.ST_EQ
    t_arr[inv[am]] = rows["t0"][am]
    t_eq[inv[em]] = rows["t1"][em]
    both = ~np.isnan(t_arr) & ~np.isnan(t_eq)
    assert both.any()
    return float(np.abs(sums[both] - (t_eq[both] - t_arr[both])).max())


@pytest.mark.parametrize("name,datapath", SIM_CASES)
def test_sim_trace_equals_the_reference(name, datapath):
    """Rows, decisions, tails, the summary, the Perfetto JSON and the
    RunReport JSON equal the JAX package's byte for byte."""
    pytest.importorskip("jax")
    from repro.api import get_scenario as jax_get_scenario
    from repro.api.runtime import make_runtime as jax_make_runtime
    from repro.telemetry.traceview import to_perfetto as jax_to_perfetto
    rep, tr = _port_run(name, datapath)
    jrep, jtr = _traced_run(_spec(jax_get_scenario, name), datapath,
                            jax_make_runtime)
    assert rep.to_json() == jrep.to_json()
    assert tr.span_count > 0 and tr.decision_count > 0
    _assert_cols_equal(tr.rows(), jtr.rows(), "rows")
    _assert_cols_equal(tr.decision_rows(), jtr.decision_rows(),
                       "decision_rows")
    for n in (1, 500):
        _assert_cols_equal(tr.tail(n), jtr.tail(n), f"tail({n})")
    assert json.dumps(tr.trace_summary()) == \
        json.dumps(jtr.trace_summary())
    names = {0: "congestor", 1: "victim"}
    for last in (None, 500):
        assert json.dumps(to_perfetto(tr, time_unit="ns", last=last,
                                      tenant_names=names)) == \
            json.dumps(jax_to_perfetto(jtr, time_unit="ns", last=last,
                                       tenant_names=names))


def test_cross_datapath_provenance_identity():
    """The same spec gives bit-identical span rows and decisions on the
    event loop and the batched datapath."""
    for name in ("fig9_congestor_victim", "qos_closed_loop"):
        _, tr_ev = _port_run(name, "event")
        _, tr_ba = _port_run(name, "batched")
        assert len(tr_ev.rows()["uid"]) > 0
        _assert_cols_equal(tr_ev.rows(), tr_ba.rows(), f"{name} rows")
        assert len(tr_ev.decision_rows()["time"]) > 0
        _assert_cols_equal(tr_ev.decision_rows(), tr_ba.decision_rows(),
                           f"{name} decisions")


def test_span_sums_reconcile_with_completion_latency():
    _, tr = _port_run("fig9_congestor_victim", "event")
    assert _reconcile(tr.rows()) <= 1.0  # within 1 virtual ns
    rows = tr.rows()
    assert np.all(rows["pu"][rows["stage"] == TR.ST_ARRIVE] == -1)


@pytest.mark.parametrize("name,datapath", SIM_CASES)
def test_trace_summary_extras_and_off_parity(name, datapath):
    """Tracing on adds exactly the ``trace_summary`` extras block and
    changes nothing else of the report, byte for byte."""
    from repro_torch.api import RunReport, get_scenario
    from repro_torch.api.runtime import make_runtime
    rep_on, tr = _port_run(name, datapath)
    spec = _spec(get_scenario, name)
    rep_off = make_runtime(spec, "sim", datapath=datapath).run(spec)
    s = rep_on.extras["trace_summary"]
    assert s["spans_recorded"] == tr.span_count
    assert s["open_spans"] == 0
    assert "trace_summary" not in rep_off.extras
    stripped = RunReport.from_json(rep_on.to_json())
    del stripped.extras["trace_summary"]
    assert stripped.to_json() == rep_off.to_json()


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def _serve_traced(get_scenario, make_runtime, name, **kw):
    spec = get_scenario(name)
    rt = make_runtime(spec, "serve", trace=True, **kw)
    rep = rt.run(spec)
    rt.flush_trace()
    return rep, rt.trace


def test_serving_backend_trace_smoke():
    """The serving engine shares the recorder seam: spans reconcile in
    step units and WLBVT grants carry provenance."""
    from repro_torch.api import get_scenario
    from repro_torch.api.runtime import make_runtime
    _, tr = _serve_traced(get_scenario, make_runtime, "qos_closed_loop")
    assert tr.span_count > 0
    assert _reconcile(tr.rows()) <= 1.0
    kinds = set(tr.decision_rows()["kind"].tolist())
    assert TR.K_PU_WLBVT in kinds


@pytest.mark.parametrize("name", ["qos_closed_loop", "serve_mixed_slo"])
def test_serve_trace_equals_the_reference(name):
    pytest.importorskip("jax")
    from repro.api import get_scenario as jax_get_scenario
    from repro.api.runtime import make_runtime as jax_make_runtime
    from repro.telemetry.traceview import to_perfetto as jax_to_perfetto
    from repro_torch.api import get_scenario
    from repro_torch.api.runtime import make_runtime
    rep, tr = _serve_traced(get_scenario, make_runtime, name)
    jrep, jtr = _serve_traced(jax_get_scenario, jax_make_runtime, name)
    assert rep.to_json() == jrep.to_json()
    _assert_cols_equal(tr.rows(), jtr.rows(), "rows")
    _assert_cols_equal(tr.decision_rows(), jtr.decision_rows(),
                       "decision_rows")
    assert json.dumps(to_perfetto(tr, time_unit="steps")) == \
        json.dumps(jax_to_perfetto(jtr, time_unit="steps"))


# ---------------------------------------------------------------------------
# Perfetto export and the trace CLI
# ---------------------------------------------------------------------------
def _span_events(doc):
    return [e for e in doc["traceEvents"]
            if e["ph"] != "M" and e.get("cat") != "decision"]


def test_perfetto_export_schema():
    _, tr = _port_run("fig9_congestor_victim", "event")
    doc = to_perfetto(tr, time_unit="ns",
                      tenant_names={0: "congestor", 1: "victim"})
    json.dumps(doc)
    ev = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["spans_recorded"] == tr.span_count
    for e in ev:
        assert e["ph"] in ("M", "i", "X", "b", "e"), e
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    threads = {(e["pid"], e["tid"]): e["args"]["name"] for e in ev
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {t for (p, t) in threads if p == PID_PU} == set(range(tr.P))
    assert threads[(PID_TENANTS, 0)] == "congestor"
    assert threads[(PID_TENANTS, 1)] == "victim"
    xs = [e for e in ev if e["ph"] == "X"]
    assert xs
    for e in xs:
        assert e["pid"] == PID_PU and 0 <= e["tid"] < tr.P
        assert e["dur"] >= 0.0
    b = Counter((e["cat"], e["id"]) for e in ev if e["ph"] == "b")
    e_ = Counter((e["cat"], e["id"]) for e in ev if e["ph"] == "e")
    assert b == e_
    d = tr.decision_rows()
    sched = [e for e in ev if e.get("cat") == "decision"]
    assert len(sched) == len(d["time"])
    assert all(e["pid"] == PID_SCHED and e["name"] in TR.REASONS
               for e in sched)


def test_perfetto_last_n_is_suffix_of_full_export():
    _, tr = _port_run("fig9_congestor_victim", "event")
    full = _span_events(to_perfetto(tr, time_unit="ns"))
    part = _span_events(to_perfetto(tr, time_unit="ns", last=500))
    assert 0 < len(part) < len(full)
    assert part == full[len(full) - len(part):]


def test_trace_cli_writes_the_reference_perfetto_file(tmp_path, capsys):
    """``launch/trace.py --out --last --console`` on both packages: the
    same Perfetto file, byte for byte."""
    from repro_torch.launch import trace as cli
    args = ["--scenario", "fig9_congestor_victim", "--set",
            "duration_us=20", "--console", "--top-k", "3"]
    out = tmp_path / "port.json"
    assert cli.main(args + ["--out", str(out), "--last", "400"]) == 0
    text = capsys.readouterr().out
    assert "spans recorded" in text and f"wrote {out}" in text
    doc = json.loads(out.read_text())
    assert doc["traceEvents"]
    pytest.importorskip("jax")
    from repro.launch import trace as jax_cli
    ref = tmp_path / "ref.json"
    assert jax_cli.main(args + ["--out", str(ref), "--last", "400"]) == 0
    assert out.read_bytes() == ref.read_bytes()


def test_trace_cli_datapaths_write_the_same_file(tmp_path, capsys):
    """``--datapath`` picks the simulator; both record identical rows,
    so both write the same Perfetto file."""
    from repro_torch.launch import trace as cli
    files = []
    for dp in ("event", "batched"):
        files.append(tmp_path / f"{dp}.json")
        assert cli.main(["--scenario", "fig9_congestor_victim", "--set",
                         "duration_us=20", "--datapath", dp,
                         "--out", str(files[-1])]) == 0
    assert files[0].read_bytes() == files[1].read_bytes()
    assert capsys.readouterr().out.count("spans recorded") == 2
