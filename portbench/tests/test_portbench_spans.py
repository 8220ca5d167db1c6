"""``portbench/spans.py`` on the CPU at smoke size: a cell served with the
program's flight recorder on, its readings against the harness's own
records, and the benchmark's runs left with the program's tracing off."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.harness.bench import run_cell
from portbench.spans import (busy_union, idle_in, read_program, run_spans,
                             self_intervals)
from portbench.tests.smoke import make_checkout

CELLS = ("qwen3-smoke.mix", "mamba2-smoke.mix")
SIX = ("engine_self_ms", "victim_grant_wait_p90_ms", "prefill_launch_ms",
       "decode_launch_ms", "prefill_valid_rows_pct", "launch_idle_share")
SEED = 2**33 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("spans"))


@pytest.fixture(scope="module", params=CELLS)
def traced(request, root):
    line = run_spans(root, request.param, SEED, 1.5, True, device="cpu",
                     log=lambda *a: None)
    return request.param, line


def test_every_reading_is_a_number(traced):
    _, line = traced
    prog = line["program"]
    for k in SIX:
        assert isinstance(prog[k], float) and np.isfinite(prog[k]), k
    assert 0 < prog["prefill_valid_rows_pct"] <= 100
    assert 0 < prog["decode_valid_rows_pct"] <= 100
    assert 0 < prog["launch_idle_share"] < 100


def test_engine_self_time_is_the_harness_twin(traced):
    _, line = traced
    run, prog = line["_run"], line["program"]
    # the harness steps (stamps around Engine.step()) hold the program's
    # steps and the harness's call wrapper, so they read a little more
    want = np.mean([s.t1 - s.t0 - s.calls for s in run.steps]) * 1e3
    assert prog["engine_self_ms"] <= want * 1.5 + 0.5
    assert prog["engine_self_ms"] > 0


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_valid_rows_match_the_harness_calls(traced, kind):
    _, line = traced
    run, prog = line["_run"], line["program"]
    calls = [c for c in run.calls if c.kind == kind]
    C = run.cell.config["deployment"]["prefill_chunk"] \
        if kind == "prefill" else 1
    want = 100.0 * sum(int(c.rows.sum()) for c in calls) / sum(
        len(c.rows) * C for c in calls)
    assert prog[f"{kind}_valid_rows_pct"] == pytest.approx(want, rel=1e-12)


def test_the_victims_grant_wait_is_the_harness_wait_from_submission(
        traced, root):
    """Over the same requests (victims submitted in the window) and from
    the same start (submission), the harness's records give the program's
    reading, up to where in its step the engine grants.  The harness's
    ``victim_queue_wait_p90_ms`` counts from the due time instead, and
    so also holds each request's wait in the client for a step to end;
    over requests due in the window it reads at least the submission
    lag less that slack."""
    name, line = traced
    run, prog = line["_run"], line["program"]
    rows, (w0, _) = line["_rows"], line["_w"]
    waits = [(min(r.grant, run.t1) if r.grant is not None else run.t1)
             - r.submitted for r in run.recs
             if r.victim and run.t0 <= r.submitted <= run.t1]
    want = float(np.percentile(waits, 90)) * 1e3
    name_ = rows["name"].astype(str)
    inw = rows["t0_ns"] >= w0
    steps = rows["t0_ns"][inw & (name_ == "engine.step")]
    assign_end = rows["t1_ns"][inw & (name_ == "engine.assign")]
    slack_ms = float((assign_end - steps).max()) / 1e6 + 1.0
    assert abs(prog["victim_grant_wait_p90_ms"] - want) <= slack_ms
    from portbench.harness.spec import load_cell
    harness = load_cell(root, name).reader("victim_queue_wait_p90_ms")(run)
    lag = [r.submitted - r.due for r in run.victims_due()]
    assert harness * 1e-3 >= min(lag) - slack_ms * 1e-3


def test_launch_idle_on_the_cpu_is_the_launch_spans_share(traced):
    _, line = traced
    rows, (w0, w1) = line["_rows"], line["_w"]
    assert not line["_ops"]
    name = rows["name"].astype(str)
    inw = (rows["t0_ns"] >= w0) & (rows["t1_ns"] <= w1)
    launch = inw & np.char.endswith(name, ".launch")
    share = 100.0 * (rows["t1_ns"] - rows["t0_ns"])[launch].sum() / (w1 - w0)
    assert line["program"]["launch_idle_share"] == pytest.approx(share,
                                                                 rel=0.02)


def test_the_idle_pieces_tile_the_window(traced):
    _, line = traced
    rows, (w0, w1) = line["_rows"], line["_w"]
    pieces = sorted(self_intervals(rows, w0, w1), key=lambda p: p[1])
    assert pieces[0][1] == w0 and pieces[-1][2] == w1
    for a, b in zip(pieces, pieces[1:]):
        assert a[2] == b[1]
    idle = line["program"]["idle_by_span"]
    assert sum(idle.values()) == pytest.approx((w1 - w0) * 1e-9, rel=1e-9)


def test_idle_is_the_complement_of_the_busy_union():
    ops = [("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0),
           ("d", -1.0, 0.5)]
    s, e = busy_union(ops, 0.0, 10.0)
    assert s.tolist() == [0.0, 1.0, 5.0] and e.tolist() == [0.5, 3.0, 6.0]
    got = idle_in(s, e, [0.0, 0.25, 2.5, 3.0], [10.0, 1.25, 5.5, 5.0])
    np.testing.assert_allclose(got, [6.5, 0.5, 2.0, 2.0])


@pytest.mark.parametrize("part, key", (
    ("queue", "victim_grant_wait_p90_ms"),
    ("prefill", "victim_prefill_p90_ms"),
    ("decode", "victim_decode_p90_ms")))
def test_read_program_counts_open_requests_to_the_window_end(part, key):
    S = 10**9
    rows = {"name": np.array([f"request.{part}"] * 3),
            "id": np.array([0, 1, -1]), "parent": np.array([-1, -1, -1]),
            "uid": np.array([0, 1, 2]), "tenant": np.array([1, 1, 0]),
            "disp": np.array([1, 0, 0]),
            "t0_ns": np.array([S, 2 * S, 2 * S]),
            "t1_ns": np.array([S + S // 10, 9 * S, 9 * S]),
            "valid": np.zeros(3, int), "computed": np.zeros(3, int)}
    out = read_program(rows, 0, 4 * S, victims=[1])
    want = np.percentile([0.1 * S, 2.0 * S], 90) / 1e6
    assert out[key] == pytest.approx(want)


@pytest.mark.parametrize("cell", CELLS)
def test_the_benchmark_runs_the_program_with_tracing_off(root, cell,
                                                         monkeypatch):
    from repro_torch.serving import engine as E
    seen = []
    real = E.Engine.__init__

    def spy(self, ecfg, executor=None):
        seen.append(ecfg.trace)
        real(self, ecfg, executor)

    monkeypatch.setattr(E.Engine, "__init__", spy)
    for trace in (False, True):
        res = run_cell(root, cell, SEED, 0.5, trace, device="cpu",
                       log=lambda *a: None)
        assert res["correct"]
    assert seen == [False, False]


def test_without_a_trace_no_idle_is_read_and_the_rest_is(root):
    line = run_spans(root, "qwen3-smoke.mix", SEED + 1, 1.0, False,
                     device="cpu", log=lambda *a: None)
    prog = line["program"]
    assert "launch_idle_share" not in prog and "idle_by_span" not in prog
    for k in SIX[:-1]:
        assert np.isfinite(prog[k]), k
    assert {"engine_host_ms", "prefill_call_ms",
            "decode_call_ms"} <= set(line["per_layer"])
    off = run_spans(root, "qwen3-smoke.mix", SEED + 1, 1.0, False,
                    program_trace=False, device="cpu", log=lambda *a: None)
    assert "program" not in off and off["_rows"] is None
    assert "engine_host_ms" in off["per_layer"]
