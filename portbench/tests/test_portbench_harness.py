"""The harness on the CPU at smoke size: cells found from files alone, the
run without a card, the correctness check against a broken timed path,
and (on a card only) one short run of each cell."""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from portbench.harness import check as CHK
from portbench.harness.bench import run_cell
from portbench.harness.spec import load_cell
from portbench.tests.smoke import REPO, SMOKE_MIX, make_checkout

CELLS = ("qwen3-smoke.mix", "mamba2-smoke.mix")
SMOKE_LIMIT = 0.05       # qwen3-smoke: the program reads <= 0.02, the
#                          control >= 0.15 (seeds 1-6)


def _line(res: dict) -> dict:
    return {k: v for k, v in res.items() if not k.startswith("_")}


def test_a_new_traffic_file_and_metric_reader_make_a_cell(tmp_path):
    """A traffic mix and a per-layer metric added as new files, and a cell
    added to BENCHMARK.json, run with no edit to any file of the
    benchmark."""
    root = make_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    mix = copy.deepcopy(SMOKE_MIX)
    mix["tenants"][1]["arrival"]["rate_per_s"] = 20.0
    (root / "portbench" / "traffic" / "bursty_chat.json").write_text(
        json.dumps(mix))
    (root / "portbench" / "metrics" / "steps_per_s.py").write_text(
        textwrap.dedent('''
            """Engine steps a second in the window."""


            def read(run):
                return len(run.steps) / run.seconds if run.steps else None
            '''))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "qwen3-smoke.bursty_chat",
                               "config": "qwen3-smoke",
                               "traffic": "bursty_chat", "chips": 1,
                               "why": "CPU test"})
    bench["per_layer"].append({"name": "steps_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "tokens_per_s",
                               "workloads": ["qwen3-smoke.bursty_chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell(root, "qwen3-smoke.bursty_chat")
    assert cell.traffic["tenants"][1]["arrival"]["rate_per_s"] == 20.0
    res = run_cell(root, "qwen3-smoke.bursty_chat", 2**33 + 7, 1.0, True,
                   device="cpu", log=lambda *a: None)
    assert res["correct"]
    assert res["metrics"]["steps_per_s"]["value"] > 0
    assert set(res["metrics"]) >= {"engine_host_ms", "prefill_call_ms",
                                   "decode_call_ms", "mfu"}
    assert list(_line(res))[-1] == "check"
    for p, body in before.items():
        assert p.read_bytes() == body, p


def test_without_a_card_the_run_fails_and_names_the_device(tmp_path):
    """No CUDA device: exit code 2, no result line, the missing device
    named on standard error."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3-8b.congested", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_the_run_fails(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: the run
    exits non-zero and prints no result."""
    root = tmp_path / "bare"
    (root / "portbench").mkdir(parents=True)
    subprocess.run(["cp", "-r", str(REPO / "portbench"), str(root)],
                   check=True)
    (root / "BENCHMARK.json").write_bytes(
        (REPO / "BENCHMARK.json").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3-8b.congested", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_every_metric(tmp_path, cell):
    root = make_checkout(tmp_path, limit=SMOKE_LIMIT)
    for trace in (False, True):
        res = run_cell(root, cell, 11, 1.0, trace, device="cpu",
                       log=lambda *a: None)
        assert res["correct"], res["check"]
        want = {m["name"] for m in
                load_cell(root, cell).metrics("per_layer" if trace
                                              else "end_to_end")}
        # the readers of the device trace find nothing on the CPU
        want -= {"prefill_device_ms", "decode_device_ms", "idle_share",
                 "decode_attention_roofline", "ssd_scan_roofline"}
        assert want <= set(res["metrics"])


class _Fault:
    """The program's executor with one fault planted underneath the
    harness."""

    def __init__(self, inner, kind: str):
        self.inner, self.kind, self.device = inner, kind, inner.device
        self.cache = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill(self, tokens, lengths, valid_n):
        if self.kind == "half_batch":
            # half of the rows with work are left out of the call
            rows = np.flatnonzero(valid_n)
            valid_n = valid_n.copy()
            valid_n[rows[: len(rows) // 2 + len(rows) % 2]] = 0
        return self.inner.prefill(tokens, lengths, valid_n)

    def decode(self, tokens, lengths, active):
        if self.kind == "state_unchanged":
            saved = [{k: t.clone() for k, t in layer.items()}
                     for layer in self.inner.cache]
            out = self.inner.decode(tokens, lengths, active)
            for layer, old in zip(self.inner.cache, saved):
                for k, t in old.items():
                    layer[k].copy_(t) if layer[k].shape == t.shape \
                        else layer.__setitem__(k, t)
            return out
        out = self.inner.decode(tokens, lengths, active)
        self.calls = getattr(self, "calls", 0) + 1
        if self.kind == "token_altered" and self.calls % 2 == 0:
            # every second step, each row's token is another one: a
            # request that served three tokens or more holds one
            out = out % 200 + 1
        return out

    def reset(self, keep):
        return self.inner.reset(keep)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    """Each fault a serving cell can have, planted underneath the harness,
    makes the check fail: a decode step that leaves the cache as it was,
    half of a prefill call's rows left out, a served token altered where
    it is produced.  (One card: no exchange between chips to leave
    out.)"""
    root = make_checkout(tmp_path, limit=SMOKE_LIMIT)
    res = run_cell(root, cell, 11, 1.5, False, device="cpu",
                   wrap_inner=lambda inner: _Fault(inner, fault),
                   log=lambda *a: None)
    assert not res["correct"], res["check"]


def test_the_control_fails_the_limit_the_program_meets(tmp_path):
    """At a size a test run holds, on three seeds: the program's widest
    gap is within the smoke limit and the control's (the reference with
    fp8 weight products, read at the same positions) is beyond it."""
    root = make_checkout(tmp_path, limit=SMOKE_LIMIT)
    for seed in (1, 2, 3):
        res = run_cell(root, "qwen3-smoke.mix", seed, 1.5, False,
                       device="cpu", control=True, log=lambda *a: None)
        served = max(float(g.max()) for g in res["_gaps"]["served"])
        control = max(float(g.max()) for g in res["_gaps"]["control"])
        assert served <= SMOKE_LIMIT < control, (seed, served, control)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen3-8b.congested",
                                  "mamba2-370m.long_docs"])
def test_each_cell_runs_correct_on_the_card(cell):
    """One run of a cell on the card, as the benchmark runs it (its
    window: a shorter one may finish no request to check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seconds = json.loads((REPO / "BENCHMARK.json").read_text())[
        "run_seconds"]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "424242", "--seconds", str(seconds), "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def _requests(mix, seed, n=40):
    from portbench.harness.traffic import Traffic
    tr = Traffic(mix, seed, 1000, 4096)
    first = tr.initial()
    return first, tr.arrivals(200.0)[:n]


def test_traffic_is_the_seeds_and_fixed_order_keeps_the_lengths():
    """The same seed gives the same requests; another seed the same
    lengths and due times in the same order, with other token ids."""
    mix = json.loads((REPO / "portbench" / "traffic"
                      / "congested.json").read_text())
    a, b = _requests(mix, 2**40 + 3), _requests(mix, 2**40 + 3)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.due == y.due and np.array_equal(x.prompt, y.prompt)
    c = _requests(mix, 5)
    assert [len(x.prompt) for x in a[0] + a[1]] \
        == [len(x.prompt) for x in c[0] + c[1]]
    assert [x.due for x in a[1]] == [x.due for x in c[1]]
    assert not np.array_equal(a[0][0].prompt, c[0][0].prompt)


def _rec(tenant, status, end, prompt_len, served):
    from portbench.harness.loop import Rec
    from types import SimpleNamespace
    req = SimpleNamespace(prompt=np.arange(prompt_len),
                          generated=list(range(served)))
    return Rec(tenant, tenant > 0, 0.0, 0.0, req, end=end, status=status)


def test_the_sample_holds_every_tenant_and_requests_in_flight():
    """Requests finished in the window and requests in flight at its end
    with a token served are drawn; each tenant's longest comes first, so
    a tenant none of whose requests finished (a batch tenant whose
    outputs outlast the window) is checked too; a request finished
    before the window, one rejected and one still in prefill are not."""
    recs = [_rec(0, "", None, 2000, 40), _rec(0, "", None, 1500, 12),
            _rec(0, "", None, 2500, 0), _rec(0, "done", 1.0, 1800, 90),
            _rec(1, "done", 12.0, 100, 30), _rec(1, "done", 14.0, 60, 8),
            _rec(2, "done", 15.0, 200, 20), _rec(2, "rejected", 13.0, 50, 0),
            _rec(2, "", None, 300, 3)]
    for seed in (1, 2, 2**40 + 1):
        s = CHK.draw_sample(recs, seed, 10.0, 20.0, tokens=50, most=10)
        assert [(x.tenant, len(x.prompt), len(x.served)) for x in s[:3]] \
            == [(0, 2000, 40), (1, 100, 30), (2, 200, 20)]
        assert {(x.tenant, len(x.prompt)) for x in s} <= {
            (0, 2000), (0, 1500), (1, 100), (1, 60), (2, 200), (2, 300)}
    every = CHK.draw_sample(recs, 3, 10.0, 20.0, tokens=10**6, most=100)
    assert len(every) == 6
    lead = CHK.draw_sample(recs, 3, 10.0, 20.0, tokens=0, most=0)
    assert [(x.tenant, len(x.prompt)) for x in lead] \
        == [(0, 2000), (1, 100), (2, 200)]


def test_a_module_of_the_jax_package_loaded_after_the_window_prints_no_result(
        tmp_path):
    """A per-layer metric reader that imports a module named ``repro`` (a
    stub here): the run names it on standard error, exits non-zero and
    prints no result line, although the look at the window's close found
    nothing."""
    root = make_checkout(tmp_path)
    stub = tmp_path / "stub" / "repro"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (root / "portbench" / "metrics" / "loads_repro.py").write_text(
        textwrap.dedent(f'''
            """Reads nothing; imports a module named like the JAX
            package."""
            import sys


            def read(run):
                sys.path.insert(0, {str(stub.parent)!r})
                import repro  # noqa: F401
                return None
            '''))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "loads_repro", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "tokens_per_s",
                               "workloads": ["qwen3-smoke.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f'''
        import sys
        from pathlib import Path
        sys.path[:0] = [{str(root)!r}, {str(REPO / "src")!r}]
        from portbench.harness.bench import run_cell
        from portbench.run import report
        res = run_cell(Path({str(root)!r}), "qwen3-smoke.mix", 5, 1.0, True,
                       device="cpu", log=lambda *a: None)
        assert res["_found"] == [], res["_found"]
        sys.exit(report(res, "qwen3-smoke.mix", 5))
        ''')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 3, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "['repro']" in out.stderr
