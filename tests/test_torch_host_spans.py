"""The serving path's wall-clock host spans (``telemetry/clock.py``, the
recorder's host-span table, the engine's and the executor's sites).

(a) ``now_ns()`` is the profiler's timeline: a span around a
``record_function`` range encloses it there, each end within 1 ms.
(b) A traced engine, over the ``NullExecutor`` and over a small CPU
``ModelExecutor``, reached through a wrapper that forwards only
``prefill`` / ``decode`` / ``reset``: parents enclose children, a step
holds each phase once, stage / launch / readback tile the executor's
call, the row counts are the call's, and every finished request has one
queue / prefill / decode span under its uid, matching its step-clock rows.
(c) Tracing off stages nothing, and an executor called outside an engine
step records nothing.  The span-balance pass covers the host spans.
"""
import dataclasses
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.analysis as TA
from repro_torch.core.slo import SLOPolicy
from repro_torch.serving.engine import Engine, EngineConfig, ModelExecutor
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.telemetry import trace as TR
from repro_torch.telemetry.clock import now_ns
from repro_torch.telemetry.trace import HOST_SPANS, TraceRecorder

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "analysis_torch"
PHASES = ("engine.control", "engine.assign", "engine.prefill",
          "engine.decode", "engine.account")
MS_NS = 1_000_000


class Forwarder:
    """Forwards the executor's three calls, and nothing else, keeping
    the rows each call carried."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []
        self.granted = []            # each prefill call's rows with work

    def prefill(self, tokens, lengths, valid_n):
        self.calls.append(("prefill", int(valid_n.sum()), valid_n.size,
                           tokens.shape[1]))
        self.granted.append(int(np.count_nonzero(valid_n)))
        return self._inner.prefill(tokens, lengths, valid_n)

    def decode(self, tokens, lengths, active):
        self.calls.append(("decode", int(np.sum(active)), len(active), 1))
        return self._inner.decode(tokens, lengths, active)

    def reset(self, keep):
        # a reset carries no row counts
        self.calls.append(("reset", 0, 0, 1))
        return self._inner.reset(keep)


def _engine(inner_fn, trace=True, depth=65536, n=10, vocab=50, seed=0):
    ecfg = EngineConfig(max_slots=4, max_len=64, prefill_chunk=8,
                        prefill_slots_per_step=2, max_tenants=2,
                        trace=trace, trace_depth=depth)
    fwd = Forwarder(inner_fn(ecfg))
    eng = Engine(ecfg, executor=fwd)
    for t in range(2):
        eng.create_ectx(t, SLOPolicy(priority=1.0 + t,
                                     kv_quota_tokens=2 * ecfg.max_len))
    rng = np.random.default_rng(seed)
    for i in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(3, 20)))
        eng.submit(Request(i % 2, prompt.astype(np.int32),
                           max_new_tokens=int(rng.integers(2, 6))))
    return eng, fwd


def _null(ecfg):
    from repro_torch.serving.engine import NullExecutor
    return NullExecutor(ecfg)


def _model(ecfg):
    from repro_torch.configs import smoke_config
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32")
    return ModelExecutor(cfg, ecfg, rng_seed=0, device="cpu")


EXECUTORS = {"null": _null, "model": _model}


@pytest.fixture(scope="module", params=sorted(EXECUTORS))
def drained(request):
    eng, fwd = _engine(EXECUTORS[request.param])
    eng.run_until_idle()
    return request.param, eng, fwd, eng.trace.host_rows()


def _by_id(rows):
    return {int(i): k for k, i in enumerate(rows["id"]) if i >= 0}


# ---------------------------------------------------------------------------
# (a) the clock is the profiler's
# ---------------------------------------------------------------------------
def test_span_encloses_a_profiler_range_on_its_timeline():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        t0_ns = now_ns()
        with record_function("inner"):
            time.sleep(0.02)
        t1_ns = now_ns()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inner"]
    assert len(ev) == 1
    a_ns, b_ns = ev[0].start_ns(), ev[0].end_ns()
    assert t0_ns <= a_ns <= t0_ns + MS_NS
    assert b_ns <= t1_ns <= b_ns + MS_NS


def test_now_ns_is_monotone_and_on_unix_time():
    a, b = now_ns(), now_ns()
    assert a <= b
    assert abs(now_ns() - time.time_ns()) < 50 * MS_NS


# ---------------------------------------------------------------------------
# (b) what a traced engine records
# ---------------------------------------------------------------------------
def test_every_parent_encloses_its_children(drained):
    _, _, _, rows = drained
    idx = _by_id(rows)
    assert np.all(rows["t0_ns"] <= rows["t1_ns"])
    n_child = 0
    for k, p in enumerate(rows["parent"]):
        if p < 0:
            continue
        j = idx[int(p)]
        assert rows["t0_ns"][j] <= rows["t0_ns"][k]
        assert rows["t1_ns"][k] <= rows["t1_ns"][j]
        n_child += 1
    assert n_child > 0


def test_a_step_holds_each_phase_once_and_they_tile_it(drained):
    _, eng, _, rows = drained
    idx = _by_id(rows)
    steps = np.flatnonzero(rows["name"] == "engine.step")
    assert len(steps) == eng.step_count
    assert np.all(rows["parent"][steps] == -1)
    kids = defaultdict(list)
    for k, p in enumerate(rows["parent"]):
        if p >= 0 and rows["name"][idx[int(p)]] == "engine.step":
            kids[int(p)].append(k)
    for s in steps:
        ks = sorted(kids[int(rows["id"][s])], key=lambda k: rows["t0_ns"][k])
        assert [rows["name"][k] for k in ks] == list(PHASES)
        assert rows["t0_ns"][ks[0]] >= rows["t0_ns"][s]
        assert rows["t1_ns"][ks[-1]] <= rows["t1_ns"][s]
        for a, b in zip(ks, ks[1:]):
            assert rows["t1_ns"][a] == rows["t0_ns"][b]


def test_executor_calls_sit_in_their_phase_with_their_rows(drained):
    _, _, fwd, rows = drained
    idx = _by_id(rows)
    phase = {"reset": "engine.assign", "prefill": "engine.prefill",
             "decode": "engine.decode"}
    calls = np.flatnonzero(np.char.startswith(rows["name"].astype(str),
                                              "executor."))
    calls = calls[np.argsort(rows["t0_ns"][calls], kind="stable")]
    assert len(calls) == len(fwd.calls)
    for k, (kind, valid, slots, chunk) in zip(calls, fwd.calls):
        assert rows["name"][k] == f"executor.{kind}"
        assert rows["name"][idx[int(rows["parent"][k])]] == phase[kind]
        assert rows["valid"][k] == valid
        assert rows["computed"][k] == slots * chunk


def test_prefill_stage_carries_the_rows_it_computes(drained):
    """The model executor's ``prefill.stage`` records the call's valid
    rows and the rows it computes: only the granted slots' chunks, while
    the engine's ``executor.prefill`` keeps the (max_slots, chunk) it
    offered."""
    which, eng, fwd, rows = drained
    names = rows["name"].astype(str)
    stages = np.flatnonzero(names == "prefill.stage")
    if which == "null":
        assert not len(stages)
        return
    stages = stages[np.argsort(rows["t0_ns"][stages], kind="stable")]
    prefills = [c for c in fwd.calls if c[0] == "prefill"]
    assert len(stages) == len(prefills) == len(fwd.granted)
    C = eng.cfg.prefill_chunk
    for k, (_, valid, _, _), granted in zip(stages, prefills, fwd.granted):
        assert 0 < granted <= eng.cfg.prefill_slots_per_step
        assert rows["valid"][k] == valid
        assert rows["computed"][k] == granted * C


def test_stage_launch_readback_tile_the_call(drained):
    which, _, fwd, rows = drained
    idx = _by_id(rows)
    parts = defaultdict(list)
    for k, p in enumerate(rows["parent"]):
        if p >= 0 and rows["name"][idx[int(p)]].startswith("executor."):
            parts[int(p)].append(k)
    if which == "null":
        assert not parts
        return
    n_calls = Counter(c[0] for c in fwd.calls)
    seen = Counter()
    for pid, ks in parts.items():
        call = idx[pid]
        kind = rows["name"][call].split(".")[1]
        seen[kind] += 1
        ks = sorted(ks, key=lambda k: rows["t0_ns"][k])
        want = ["stage", "launch"] + (["readback"] if kind != "reset"
                                      else [])
        assert [rows["name"][k] for k in ks] == [f"{kind}.{w}"
                                                 for w in want]
        for a, b in zip(ks, ks[1:]):
            assert rows["t1_ns"][a] == rows["t0_ns"][b]
        assert rows["t0_ns"][call] <= rows["t0_ns"][ks[0]]
        assert rows["t1_ns"][ks[-1]] <= rows["t1_ns"][call]
    assert seen == n_calls


def test_each_request_has_its_lifecycle_under_one_uid(drained):
    _, eng, _, rows = drained
    step_rows = eng.trace.rows()
    steps = np.flatnonzero(rows["name"] == "engine.step")
    steps = steps[np.argsort(rows["t0_ns"][steps])]

    def in_step(t_ns, n):
        s = steps[int(n)]
        return rows["t0_ns"][s] <= t_ns <= rows["t1_ns"][s]

    life = defaultdict(list)
    for k in np.flatnonzero(np.char.startswith(rows["name"].astype(str),
                                               "request.")):
        life[int(rows["uid"][k])].append(k)
    done = [r for r in eng.done if r.status == RequestStatus.DONE]
    assert len(done) == len(life) == 10
    for uid, ks in life.items():
        ks = sorted(ks, key=lambda k: rows["t0_ns"][k])
        assert [rows["name"][k] for k in ks] == [
            "request.queue", "request.prefill", "request.decode"]
        for a, b in zip(ks, ks[1:]):
            assert rows["t1_ns"][a] == rows["t0_ns"][b]
        assert set(rows["disp"][ks].tolist()) == {TR.D_OK}
        mine = step_rows["uid"] == uid
        stage = step_rows["stage"][mine]
        fmq = np.flatnonzero(mine)[stage == TR.ST_FMQ][0]
        eq = np.flatnonzero(mine)[stage == TR.ST_EQ][0]
        assert set(rows["tenant"][ks].tolist()) == {
            int(step_rows["tenant"][fmq])}
        assert in_step(rows["t1_ns"][ks[0]], step_rows["t1"][fmq])
        assert in_step(rows["t1_ns"][ks[2]], step_rows["t0"][eq])


def test_open_requests_read_out_open_and_a_kill_ends_its_span():
    eng, _ = _engine(_null, n=6)
    eng.step()
    eng.step()
    rows = eng.trace.host_rows()
    open_ = rows["disp"] == TR.D_OPEN
    assert open_.sum() == 6
    assert set(rows["uid"][open_].tolist()) == set(range(6))
    assert np.all(rows["t1_ns"][open_] >= rows["t0_ns"][open_])
    assert eng.trace.host_rows()["disp"].tolist().count(TR.D_OPEN) == 6
    eng.destroy_ectx(1)
    rows = eng.trace.host_rows()
    ended = rows["tenant"] == 1
    assert set(rows["disp"][ended & np.char.startswith(
        rows["name"].astype(str), "request.")].tolist()) <= {
        TR.D_OK, TR.D_KILL, TR.D_REJECT}
    assert not np.any(ended & (rows["disp"] == TR.D_OPEN))


def test_host_ring_keeps_the_newest_rows_in_order():
    eng, _ = _engine(_null, depth=64)
    eng.run_until_idle()
    tr = eng.trace
    rows = tr.host_rows()
    assert tr.host_count > 64
    assert len(rows["id"]) == 64
    ref, _ = _engine(_null)
    ref.run_until_idle()
    full = ref.trace.host_rows()
    np.testing.assert_array_equal(rows["name"], full["name"][-64:])
    np.testing.assert_array_equal(rows["id"], full["id"][-64:])


def test_host_names_are_the_table_and_unknown_codes_are_none():
    tr = TraceRecorder(2)
    tr.host_root(TR.H_STEP)
    tr.host_begin(TR.H_EXE_DECODE, 3, 4)
    tr.host_end()
    tr.host_end()
    rows = tr.host_rows()
    assert rows["name"].tolist() == ["executor.decode", "engine.step"]
    assert rows["parent"].tolist() == [int(rows["id"][1]), -1]
    assert (rows["valid"].tolist(), rows["computed"].tolist()) == (
        [3, 0], [4, 0])
    assert len(HOST_SPANS) == len(set(HOST_SPANS)) == TR.H_REQ_DECODE + 1


# ---------------------------------------------------------------------------
# (c) tracing off, and calls outside a step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", sorted(EXECUTORS))
def test_tracing_off_stages_nothing_and_serves_the_same(which):
    on, fon = _engine(EXECUTORS[which])
    off, foff = _engine(EXECUTORS[which], trace=False)
    on.run_until_idle()
    off.run_until_idle()
    assert off.trace is None and TR.bound() is None
    assert fon.calls == foff.calls
    assert [r.generated for r in on.done] == [r.generated for r in off.done]


def test_an_executor_outside_a_step_records_nothing():
    eng, fwd = _engine(_model, n=2)
    eng.step()
    assert TR.bound() is None
    before = eng.trace.host_rows()
    B = eng.cfg.max_slots
    with torch.no_grad():
        fwd.decode(np.ones(B, np.int32), np.full(B, 4, np.int32),
                   np.ones(B, bool))
    after = eng.trace.host_rows()
    assert after["name"].tolist() == before["name"].tolist()


class _Faulty(Forwarder):
    """Raises from the first decode call."""

    def decode(self, tokens, lengths, active):
        raise RuntimeError("decode failed")


def test_a_step_that_raises_leaves_no_recorder_bound_and_no_span_open():
    ecfg = EngineConfig(max_slots=4, max_len=64, prefill_chunk=8,
                        prefill_slots_per_step=2, max_tenants=2, trace=True)
    inner = _model(ecfg)
    eng = Engine(ecfg, executor=_Faulty(inner))
    eng.create_ectx(0, SLOPolicy(kv_quota_tokens=2 * ecfg.max_len))
    eng.submit(Request(0, np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=3))
    with pytest.raises(RuntimeError, match="decode failed"):
        eng.step()
    assert TR.bound() is None
    assert not eng.trace._host_stack
    before = eng.trace.host_rows()
    B = ecfg.max_slots
    with torch.no_grad():
        inner.decode(np.ones(B, np.int32), np.full(B, 4, np.int32),
                     np.ones(B, bool))
    after = eng.trace.host_rows()
    assert after["name"].tolist() == before["name"].tolist()
    # the failed step closed nothing it had open
    assert "engine.step" not in before["name"].tolist()
    eng.exe = Forwarder(inner)
    eng.step()
    rows = eng.trace.host_rows()
    step = np.flatnonzero(rows["name"] == "engine.step")
    assert len(step) == 1 and rows["parent"][step[0]] == -1


# ---------------------------------------------------------------------------
# the span-balance pass over host spans
# ---------------------------------------------------------------------------
def _span_balance(root, name):
    return TA.RULE_REGISTRY["span-balance"](scope=("*",)).run(
        TA.RepoIndex.load(str(root), paths=[name], excludes=()))


def test_span_balance_flags_host_span_faults():
    bad = _span_balance(FIXTURES, "host_span_bad.py")
    assert sorted(f.symbol for f in bad) == ["numeric_name", "queue_only",
                                             "step_left_open"]
    assert not _span_balance(FIXTURES, "host_span_good.py")


def test_span_balance_sees_an_unclosed_span_in_the_engine(tmp_path):
    src = (REPO / "src/repro_torch/serving/engine.py").read_text()
    assert not _span_balance(REPO, "src/repro_torch/serving/engine.py")
    cut = src.replace("            tr.host_end()\n        self.step_count",
                      "        self.step_count", 1)
    assert cut != src
    (tmp_path / "engine.py").write_text(cut)
    found = _span_balance(tmp_path, "engine.py")
    assert [f.symbol for f in found] == ["Engine._step"]
