"""``EngineConfig.cuda_graphs``: ``ModelExecutor``'s decode call and its
granted-rows prefill replayed from CUDA graphs serve the tokens the eager
calls serve.

The model is ``test_torch_deepseek_published``'s small published-shaped
DeepSeek-V2 (MLA, YaRN, the dropless ``grouped`` MoE dispatch).  A
script of calls drives two executors on the same weights, one eager and
one replaying: prefill chunks with 1 to 3 granted rows (3 is more than
the graphs are captured for, so that call runs eagerly between
replays), the whole chunk, decode steps with a slot sitting out, and a
reset.  On the CPU a graph's replay is stood in for by running the
captured function again on the static buffers, which holds the
executor's plumbing (static inputs, outputs back to their rows, the
reset after capture); the ``gpu`` case captures real graphs, in bf16 as
the benchmark's cell serves (fp32 grouped products take the library's
fallback, which reads the group offsets on the host and so cannot be
captured).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import test_torch_deepseek_published as DS  # noqa: E402
from portbench.harness.bench import bind  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import call_graphs as CG  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ModelExecutor  # noqa: E402

B, C, MAX_LEN = 4, 16, 128


def _ecfg(**kw):
    return EngineConfig(max_slots=B, max_len=MAX_LEN, prefill_chunk=C,
                        prefill_slots_per_step=2, **kw)


def _executor(device, dtype="float32", **kw):
    cfg = dataclasses.replace(DS._cfg(), dtype=dtype, param_dtype=dtype)
    # fp32: the reference's draw held in fp32; bf16: the draw as drawn
    W = (DS._weights() if dtype == "float32"
         else DS.REF.draw(DS.PUB, 11, "cpu"))
    module = build_model(cfg).init(L.generator("meta", 0))
    bind(module, {k: v.to(device) for k, v in W.items()})
    return ModelExecutor(cfg, _ecfg(**kw), params=module, device=device)


def _script(exe):
    """The tokens every call of the script returns, in order (copies: on
    the CPU the stand-in's output is a view of its static tensor)."""
    rng = np.random.default_rng(3)
    lengths = np.zeros(B, np.int32)
    out = []

    def prefill(rows):
        toks = rng.integers(1, DS.PUB["vocab_size"], (B, C)).astype(np.int32)
        valid = np.zeros(B, np.int32)
        valid[rows] = rng.integers(1, C + 1, len(rows))
        got = exe.prefill(toks, lengths.copy(), valid)
        lengths[:] += valid
        out.append(np.array(got))

    def decode(active):
        toks = rng.integers(1, DS.PUB["vocab_size"], B).astype(np.int32)
        out.append(np.array(exe.decode(toks, lengths.copy(), active)))
        lengths[:] += active

    prefill([0])
    prefill([1, 3])
    prefill([0, 1, 2])                   # more rows than were captured
    prefill([2])
    prefill([0, 1, 2, 3])                # the whole chunk
    for step in range(4):
        active = np.ones(B, bool)
        active[1] = step != 2
        decode(active)
    exe.reset(np.array([True, False, True, True]))
    lengths[1] = 0
    prefill([1])
    decode(np.ones(B, bool))
    return out


class _Rerun:
    """A graph's stand-in on the CPU: replay runs the function again on
    the static buffers and writes its tokens into the static output."""

    def __init__(self, fn, params, cache, args, out):
        self.call = lambda: fn(params, cache, *args)[0]
        self.out = out

    def replay(self):
        self.out.copy_(self.call())


def _rerun_capture(self, fn, params, cache, args):
    out = fn(params, cache, *args)[0].clone()
    return _Rerun(fn, params, cache, args, out), out


def test_cuda_graphs_refuse_an_executor_off_the_card():
    with pytest.raises(ValueError, match="cuda_graphs"):
        _executor("cpu", cuda_graphs=True)


def test_replayed_calls_serve_the_eager_tokens(monkeypatch):
    monkeypatch.setattr(CG.CallGraphs, "_capture", _rerun_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    eager = _executor("cpu")
    replayed = _executor("cpu")
    # what the executor does with cuda_graphs on a card
    replayed._graphs = CG.CallGraphs(replayed.fns, replayed.params,
                                     replayed.cache, batch=B, chunk=C,
                                     max_rows=2)
    replayed.reset(np.zeros(B, bool))
    assert sorted(replayed._graphs._rows) == [1, 2]
    calls = []
    real = CG.CallGraphs.decode, CG.CallGraphs.prefill_rows
    monkeypatch.setattr(CG.CallGraphs, "decode", lambda s, *a: (
        calls.append("decode"), real[0](s, *a))[1])
    monkeypatch.setattr(CG.CallGraphs, "prefill_rows", lambda s, *a: (
        calls.append(len(a[0])), real[1](s, *a))[1])
    want, got = _script(eager), _script(replayed)
    assert calls == [1, 2, 1] + ["decode"] * 4 + [1, "decode"]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_graphs_on_the_card_serve_the_eager_tokens():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured there")
    eager = _executor("cuda", "bfloat16")
    replayed = _executor("cuda", "bfloat16", cuda_graphs=True)
    assert sorted(replayed._graphs._rows) == [1, 2]
    for w, g in zip(_script(eager), _script(replayed)):
        np.testing.assert_array_equal(g, w)
