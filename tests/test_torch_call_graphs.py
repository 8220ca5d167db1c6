"""``ModelExecutor``'s decode call and its granted-rows prefill replayed
from CUDA graphs serve the tokens the eager calls serve.

Five small models, one a family whose serve functions capture: the
published-shaped DeepSeek-V2 of ``test_torch_deepseek_published`` (MLA,
YaRN, the dropless ``grouped`` MoE dispatch), and the smoke configs of
Qwen3-8B (dense GQA), Mamba2-370M (SSD), RecurrentGemma-2B (RG-LRU
beside local attention) and Whisper-large-v3 (the encoder-decoder,
served over the zero cross K/V), all under the hand-written kernels as
served.
A script of calls drives two executors on the same weights, one eager
and one replaying: prefill chunks with 1 to 3 granted rows (3 is more
than the graphs are captured for, so that call runs eagerly between
replays), the whole chunk (eager, as the benchmark's warm-up runs it),
decode steps with a slot sitting out, and a reset.

On the CPU a graph's replay is stood in for by running the captured
function again on the static buffers and on the cache's tensors as they
were at capture (a graph reads fixed addresses: a layer that rebinds its
cache entries instead of writing them in place serves stale state here,
as on the card).  That holds the executor's plumbing (static inputs,
outputs back to their rows, the reset after capture).  The ``gpu``
cases capture real graphs at the cells' dtypes: bf16 parameters for
DeepSeek, fp32 parameters cast to bf16 for the others (fp32 grouped
products take the library's fallback, which reads the group offsets on
the host and so cannot be captured).
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
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import call_graphs as CG  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ModelExecutor  # noqa: E402

B, C, MAX_LEN = 4, 16, 128
# family -> the smoke config's arch (DeepSeek: the published-shaped one)
ARCHS = {"dense_gqa": "qwen3-8b", "ssd": "mamba2-370m",
         "rglru": "recurrentgemma-2b", "enc_dec": "whisper-large-v3"}


def _ecfg(**kw):
    return EngineConfig(max_slots=B, max_len=MAX_LEN, prefill_chunk=C,
                        prefill_slots_per_step=2, **kw)


def _executor(device, dtype="float32", family="mla_moe", **kw):
    """``family``'s executor on ``device``; ``dtype`` the compute dtype.
    DeepSeek holds its parameters in it, the others in fp32, as their
    cells do."""
    if family != "mla_moe":
        cfg = dataclasses.replace(smoke_config(ARCHS[family]),
                                  attn_impl="pallas", dtype=dtype,
                                  param_dtype="float32")
        return ModelExecutor(cfg, _ecfg(**kw), rng_seed=5, device=device)
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
    vocab = exe.fns.cfg.vocab_size
    lengths = np.zeros(B, np.int32)
    out = []

    def prefill(rows):
        toks = rng.integers(1, vocab, (B, C)).astype(np.int32)
        valid = np.zeros(B, np.int32)
        valid[rows] = rng.integers(1, C + 1, len(rows))
        got = exe.prefill(toks, lengths.copy(), valid)
        lengths[:] += valid
        out.append(np.array(got))

    def decode(active):
        toks = rng.integers(1, vocab, B).astype(np.int32)
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


# the calls of the script that replay (rows granted, or "decode"), and
# how many calls of each kind it makes
SCRIPT_REPLAYS = [1, 2, 1] + ["decode"] * 4 + [1, "decode"]
SCRIPT_CALLS = {"decode": 5, "prefill": 6}


class _Rerun:
    """A graph's stand-in on the CPU: replay runs the function again on
    the static buffers and on the cache's tensors of capture time, and
    writes its tokens into the static output."""

    def __init__(self, fn, params, cache, args, out):
        frozen = [dict(layer) for layer in cache]
        self.call = lambda: fn(params, frozen, *args)[0]
        self.out = out

    def replay(self):
        self.out.copy_(self.call())


def _rerun_capture(self, fn, params, cache, args):
    out = fn(params, cache, *args)[0].clone()
    return _Rerun(fn, params, cache, args, out), out, {}


def test_cuda_graphs_refuse_an_executor_off_the_card():
    with pytest.raises(ValueError, match="cuda_graphs"):
        _executor("cpu", cuda_graphs=True)


def _stand_in_replays_serve_the_eager_tokens(monkeypatch, family):
    """The script on an eager executor and on one replaying through the
    stand-in: the same tokens, the replays where the script says.
    Returns the replaying executor."""
    monkeypatch.setattr(CG.CallGraphs, "_capture", _rerun_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    eager = _executor("cpu", family=family)
    replayed = _executor("cpu", family=family)
    assert eager._graphs is None and replayed._graphs is None
    # what the executor does on a card
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
    assert calls == SCRIPT_REPLAYS
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    return replayed


def test_replayed_calls_serve_the_eager_tokens(monkeypatch):
    _stand_in_replays_serve_the_eager_tokens(monkeypatch, "mla_moe")


@pytest.mark.parametrize("family", list(ARCHS))
def test_replayed_calls_serve_the_eager_tokens_of_each_family(monkeypatch,
                                                             family):
    _stand_in_replays_serve_the_eager_tokens(monkeypatch, family)


def test_executor_counts_its_replayed_and_eager_calls(monkeypatch):
    exe = _stand_in_replays_serve_the_eager_tokens(monkeypatch, "ssd")
    assert exe.replayed == {
        "decode": SCRIPT_REPLAYS.count("decode"),
        "prefill": len(SCRIPT_REPLAYS) - SCRIPT_REPLAYS.count("decode")}
    assert {k: exe.replayed[k] + exe.eager[k] for k in SCRIPT_CALLS} \
        == SCRIPT_CALLS
    eager = _executor("cpu", family="ssd")
    _script(eager)
    assert eager.replayed == {"decode": 0, "prefill": 0}
    assert eager.eager == SCRIPT_CALLS


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured there")


@pytest.mark.gpu
def test_graphs_on_the_card_serve_the_eager_tokens():
    _needs_card()
    eager = _executor("cuda", "bfloat16", cuda_graphs=False)
    replayed = _executor("cuda", "bfloat16", cuda_graphs=True)
    assert sorted(replayed._graphs._rows) == [1, 2]
    for w, g in zip(_script(eager), _script(replayed)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("family", list(ARCHS))
def test_graphs_on_the_card_serve_the_eager_tokens_of_each_family(family):
    """Captured by default (``cuda_graphs`` None) on the card."""
    _needs_card()
    eager = _executor("cuda", "bfloat16", family, cuda_graphs=False)
    replayed = _executor("cuda", "bfloat16", family)
    assert eager._graphs is None
    assert sorted(replayed._graphs._rows) == [1, 2]
    for w, g in zip(_script(eager), _script(replayed)):
        np.testing.assert_array_equal(g, w)
    assert replayed.replayed == {
        "decode": SCRIPT_REPLAYS.count("decode"),
        "prefill": len(SCRIPT_REPLAYS) - SCRIPT_REPLAYS.count("decode")}


def _traced_launches(call, name: str) -> int:
    """Kernels whose name holds ``name`` in a profiler trace of
    ``call()``: read from the device's records, so a replay's kernels
    count as launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key)


@pytest.mark.gpu
@pytest.mark.parametrize("family,kernel,name", [
    ("dense_gqa", "decode_attention", "decode_attention_kernel"),
    ("ssd", "ssd_scan", "ssd_scan")])
def test_replays_count_the_eager_launches(family, kernel, name):
    """A replayed decode and a replayed 2-row prefill add to
    ``ops.LAUNCHES`` what the eager calls add, and launch on the device
    (by a profiler trace of the replay) what the eager calls count;
    building the graphs adds nothing."""
    _needs_card()
    eager = _executor("cuda", "bfloat16", family, cuda_graphs=False)
    before = dict(ops.LAUNCHES)
    replayed = _executor("cuda", "bfloat16", family, cuda_graphs=True)
    assert ops.LAUNCHES == before
    vocab = eager.fns.cfg.vocab_size
    toks = np.arange(B * C, dtype=np.int32).reshape(B, C) % vocab + 1
    valid = np.array([C, 0, 5, 0], np.int32)
    calls = [("prefill", (toks, np.zeros(B, np.int32), valid)),
             ("decode", (toks[:, 0], np.array([C, 0, 5, 0], np.int32),
                         np.ones(B, bool)))]
    counts, traced = {}, {}
    for way, exe in (("eager", eager), ("replayed", replayed)):
        for kind, args in calls:
            n0 = dict(ops.LAUNCHES)
            traced[way, kind] = _traced_launches(
                lambda: getattr(exe, kind)(*args), name)
            counts[way, kind] = {k: n - n0[k] for k, n in
                                 ops.LAUNCHES.items() if n != n0[k]}
    assert replayed.replayed == {"decode": 1, "prefill": 1}
    for kind, _ in calls:
        assert counts["replayed", kind] == counts["eager", kind], kind
        assert traced["replayed", kind] == traced["eager", kind] \
            == counts["eager", kind].get(kernel, 0), kind
    assert any(counts["eager", kind].get(kernel) for kind, _ in calls)
