"""The one-device serve functions keep the cache's storage, and who may
capture them.

A CUDA graph reads and writes the addresses it was captured on, so every
serve function must write each cache tensor in place: for every
registered family (smoke configs on the CPU), ``decode``,
``prefill_chunk``, ``prefill_rows`` and ``reset_slots`` leave every
tensor of the cache at its ``data_ptr()``.  The SSD and RG-LRU layers'
in-place writes hold the values their out-of-place updates gave, bit for
bit: the decode recurrences as ``state * dA + dBx`` and ``a * h + b``
computed apart, the prefill's carried state as the scan returned it, the
conv windows as the conv returned them.  ``ServeFns.capturable`` and
``ModelExecutor.replays`` decide where ``EngineConfig.cuda_graphs`` None
captures: one CUDA device, no mesh, a family whose calls capture.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import list_archs, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SM
from repro_torch.serving.engine import EngineConfig, ModelExecutor
from repro_torch.serving.serve_step import build_serve_fns

B, C, MAX_LEN = 4, 16, 64


def _grouped(arch, dtype):
    cfg = smoke_config(arch)
    return dataclasses.replace(
        cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe,
                                                  serve_impl="grouped"))


# name -> (config, capturable)
CONFIGS = {arch: (smoke_config(arch), arch not in (
    "llama4-maverick-400b-a17b", "deepseek-v2-lite-16b"))  # gshard MoE
    for arch in list_archs()}
CONFIGS["deepseek-grouped-bf16"] = (
    _grouped("deepseek-v2-lite-16b", "bfloat16"), True)
CONFIGS["deepseek-grouped-fp32"] = (
    _grouped("deepseek-v2-lite-16b", "float32"), False)


def _fns(cfg):
    return build_serve_fns(cfg, batch=B, max_len=MAX_LEN, prefill_chunk=C,
                           device="cpu")


def _calls(fns):
    """(name, thunk(params, cache)) of every one-device serve function."""
    g = torch.Generator().manual_seed(1)
    V = fns.cfg.vocab_size
    toks = torch.randint(1, V, (B, C), generator=g, dtype=torch.int32)
    i32 = dict(dtype=torch.int32)
    return [
        ("prefill_chunk", lambda p, c: fns.prefill_chunk(
            p, c, toks, torch.zeros(B, **i32), torch.full((B,), C, **i32))),
        ("prefill_rows", lambda p, c: fns.prefill_rows(
            p, c, torch.tensor([1, 3]), toks, torch.full((B,), C, **i32),
            torch.tensor([0, 5, 0, C], **i32))),
        ("decode", lambda p, c: fns.decode(
            p, c, toks[:, 0], torch.tensor([C, C + 5, C, 2 * C], **i32),
            torch.tensor([True, True, False, True]))),
        ("reset_slots", lambda p, c: (fns.reset_slots(
            c, torch.tensor([True, False, True, True])),)),
    ]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_functions_keep_the_cache_storage(name):
    cfg, capturable = CONFIGS[name]
    fns = _fns(cfg)
    assert fns.capturable == capturable
    params, cache = fns.init_params(0), fns.init_cache()
    where = [{k: t.data_ptr() for k, t in layer.items()} for layer in cache]
    for call, run in _calls(fns):
        if call == "prefill_rows" and fns.prefill_rows is None:
            continue                    # gshard MoE: the whole chunk only
        out = run(params, cache)
        assert out[-1] is cache, call
        assert [{k: t.data_ptr() for k, t in layer.items()}
                for layer in cache] == where, call


def test_replay_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rule = ModelExecutor.replays
    assert rule(None, cuda, None, True)
    assert not rule(None, cuda, None, False)        # e.g. fp32 grouped MoE
    assert not rule(None, cuda, object(), True)     # a mesh
    assert not rule(None, cpu, None, True)
    assert not rule(False, cuda, None, True)
    assert rule(True, cuda, None, False)            # required: capture
    #                                                 raises if it cannot
    for dev, mesh in ((cpu, None), (cuda, object())):
        with pytest.raises(ValueError, match="cuda_graphs"):
            rule(True, dev, mesh, True)


def test_default_stays_eager_on_the_cpu():
    ecfg = EngineConfig(max_slots=B, max_len=MAX_LEN, prefill_chunk=C)
    assert ecfg.cuda_graphs is None
    for cfg, capturable in (CONFIGS["mamba2-370m"],
                            CONFIGS["deepseek-grouped-fp32"]):
        exe = ModelExecutor(cfg, ecfg, device="cpu")
        assert exe.fns.capturable == capturable
        assert exe._graphs is None


def _old_ssd_decode_step(x, dt, A_log, B_mat, C_mat, state):
    """The decode recurrence out of place, as it was computed before the
    state was updated in the cache."""
    xf = x.float()[:, 0]
    dtf = dt.float()[:, 0]
    rep = xf.shape[1] // B_mat.shape[2]
    Bf = B_mat.float().repeat_interleave(rep, dim=2)[:, 0]
    Cf = C_mat.float().repeat_interleave(rep, dim=2)[:, 0]
    dA = torch.exp(dtf * (-torch.exp(A_log.float()))[None, :])
    new_state = state * dA[..., None, None] + torch.einsum(
        "bhn,bh,bhp->bhpn", Bf, dtf, xf)
    y = torch.einsum("bhn,bhpn->bhp", Cf, new_state)
    return y[:, None].to(x.dtype), new_state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_decode_in_place_is_the_old_update_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(2)
    Bb, H, P, G, N = 3, 4, 8, 2, 16

    def r(*shape, dt=torch.float32):
        return torch.randn(shape, generator=g).to(dt)
    x, dt, A_log = r(Bb, 1, H, P, dt=dtype), r(Bb, 1, H).abs(), r(H)
    B_mat, C_mat = r(Bb, 1, G, N, dt=dtype), r(Bb, 1, G, N, dt=dtype)
    state = r(Bb, H, P, N)
    want_y, want_state = _old_ssd_decode_step(x, dt, A_log, B_mat, C_mat,
                                              state.clone())
    ptr = state.data_ptr()
    y = SM.ssd_decode_step(x, dt, A_log, B_mat, C_mat, state)
    assert state.data_ptr() == ptr
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


def _recording(monkeypatch, module, name, seen, keep=lambda args, out: out):
    real = getattr(module, name)

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        seen.append(keep(args, out))
        return out
    monkeypatch.setattr(module, name, wrapped)


def _recurrent(cache, key):
    return [layer for layer in cache if key in layer]


@pytest.mark.parametrize("call", ["prefill_chunk", "decode"])
def test_ssd_cache_writes_hold_the_old_values(monkeypatch, call):
    """Mamba2's served call: each layer's state and conv windows in the
    cache are, bit for bit, what the recurrence (decode: computed out of
    place from the recorded inputs) or the scan (prefill) and the convs
    returned."""
    cfg = dataclasses.replace(smoke_config("mamba2-370m"), attn_impl="pallas")
    fns = _fns(cfg)
    params, cache = fns.init_params(0), fns.init_cache()
    run = dict(_calls(fns))
    run["prefill_chunk"](params, cache)          # a carried state
    steps, scans, convs = [], [], []
    real_step = SM.ssd_decode_step

    def step(x, dt, A_log, B_mat, C_mat, state):
        steps.append(_old_ssd_decode_step(x, dt, A_log, B_mat, C_mat,
                                          state.clone())[1])
        return real_step(x, dt, A_log, B_mat, C_mat, state)
    monkeypatch.setattr(SM, "ssd_decode_step", step)
    _recording(monkeypatch, ops, "ssd_scan", scans, lambda a, out: out[1])
    _recording(monkeypatch, SM, "causal_conv", convs, lambda a, out: out[1])
    run[call](params, cache)
    layers = _recurrent(cache, "state")
    want = steps if call == "decode" else scans
    assert len(want) == len(layers) and len(convs) == 3 * len(layers)
    for i, layer in enumerate(layers):
        assert torch.equal(layer["state"], want[i])
        for j, k in enumerate(("conv_x", "conv_B", "conv_C")):
            assert torch.equal(layer[k], convs[3 * i + j])


@pytest.mark.parametrize("call", ["prefill_chunk", "decode"])
def test_rglru_cache_writes_hold_the_old_values(monkeypatch, call):
    """RecurrentGemma's served call: each RG-LRU layer's h and conv
    window in the cache are what ``a * h + b`` (decode, all slots active)
    or the scan (prefill) and the conv gave."""
    cfg = dataclasses.replace(smoke_config("recurrentgemma-2b"),
                              attn_impl="pallas")
    fns = _fns(cfg)
    params, cache = fns.init_params(0), fns.init_cache()
    run = dict(_calls(fns))
    run["prefill_chunk"](params, cache)          # a carried h
    layers = _recurrent(cache, "h")
    h0 = [layer["h"].clone() for layer in layers]
    gates, scans, convs = [], [], []
    _recording(monkeypatch, R, "_gates", gates)
    _recording(monkeypatch, ops, "rglru_scan", scans, lambda a, out: out[1])
    _recording(monkeypatch, R, "causal_conv", convs, lambda a, out: out[1])
    if call == "decode":
        fns.decode(params, cache, torch.ones(B, dtype=torch.int32),
                   torch.full((B,), C, dtype=torch.int32),
                   torch.ones(B, dtype=torch.bool))
        want = [a[:, 0] * h + b[:, 0] for (a, b), h in zip(gates, h0)]
    else:
        run[call](params, cache)
        want = scans
    assert len(want) == len(layers) == len(convs)
    for layer, h, conv in zip(layers, want, convs):
        assert torch.equal(layer["h"], h)
        assert torch.equal(layer["conv"], conv)
