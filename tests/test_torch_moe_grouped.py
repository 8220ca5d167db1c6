"""The dropless ``grouped`` MoE dispatch (``models/moe.py``) on the CPU, at
the DeepSeek-V2-Lite smoke widths (8 experts, top-2, a shared expert).

Its function is ``ragged``'s; a row's output does not depend on the
other rows of the call, where ``gshard``'s does at a capacity that
drops; nothing drops when every token routes to one expert; the route
counters read 0 dropped under ``grouped`` and the true count under
``gshard``; a ``grouped`` model takes ``prefill_rows`` and its tokens are
the whole chunk's; the engine's tracing records the counters and the
``moe.route`` spans, and nothing without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.serving.engine import EngineConfig, ModelExecutor
from repro_torch.serving.serve_step import build_serve_fns

ARCH = "deepseek-v2-lite-16b"


def _cfg(dtype="float32", **moe):
    cfg = smoke_config(ARCH)
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                               moe=dataclasses.replace(cfg.moe, **moe))


def _moe(cfg, seed=0):
    return M.MoE(cfg, L.generator("cpu", seed))


def _x(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("norm", [True, False])
def test_grouped_equals_ragged_token_for_token(norm):
    cfg = _cfg(norm_topk_prob=norm)
    p = _moe(cfg)
    x = _x((3, 11, cfg.d_model), 1)
    want, aux_r = M.apply_moe_ragged(p, x, cfg)
    got, aux_g = M.apply_moe_grouped(p, x, cfg)
    assert (got - want).abs().max().item() <= 1e-5
    assert aux_g == aux_r


def test_a_rows_output_is_its_own():
    """bf16 (the serving dtype; on the CPU an fp32 product of one row takes
    another kernel than of several, bf16's does not): the last row's
    output is bit-identical whatever the other 15 rows hold under
    ``grouped``; under ``gshard`` at capacity factor 0.5, which drops (the
    last row queues behind the others), it is not."""
    cfg = _cfg("bfloat16")
    p = _moe(cfg)
    x = _x((16, 1, cfg.d_model), 2, torch.bfloat16)
    moved = False
    for seed in range(3, 11):
        y = torch.cat([_x((16, 1, cfg.d_model), seed,
                          torch.bfloat16)[:-1], x[-1:]])
        a, _ = M.apply_moe_grouped(p, x, cfg)
        b, _ = M.apply_moe_grouped(p, y, cfg)
        assert torch.equal(a[-1], b[-1])
        ga, _ = M.apply_moe_gshard(p, x, cfg, capacity_factor=0.5)
        gb, _ = M.apply_moe_gshard(p, y, cfg, capacity_factor=0.5)
        moved |= not torch.equal(ga[-1], gb[-1])
    assert moved


def _one_expert(cfg, p):
    """Every token's router logits put expert 3 first (and, the others
    tied, expert 0 second)."""
    with torch.no_grad():
        p.router.zero_()
        p.router[:, 3] = 1.0
    return _x((2, 8, cfg.d_model), 5).abs() + 0.1


def test_nothing_drops_when_every_token_routes_to_one_expert():
    """16 tokens all on experts 3 and 0: ``grouped`` gives each token its
    ragged output and the counters read no drop; ``gshard`` at its
    capacity (16 x 2 x 1.25 / 8 = 5) drops 11 of each expert's 16."""
    cfg = _cfg()
    p = _moe(cfg)
    x = _one_expert(cfg, p)
    want, _ = M.apply_moe_ragged(p, x, cfg)
    with M.counting("cpu") as acc:
        got, _ = M.apply_moe_grouped(p, x, cfg)
    assert (got - want).abs().max().item() <= 1e-5
    routed, hit, most, dropped = acc.tolist()
    assert (routed, hit, most, dropped) == (32, 2, 16, 0)
    with M.counting("cpu") as acc:
        g, _ = M.apply_moe_gshard(p, x, cfg)
    assert acc.tolist() == [32, 2, 5, 22]
    assert (g - want).abs().max().item() > 1e-3


def _gshard_drops(idx, valid, k, E, C, group):
    """Assignments of valid rows past their expert's capacity, counted in
    a plain loop (token-major queue order within each group)."""
    T = idx.shape[0]
    n = 0
    for g0 in range(0, T, group):
        fill = [0] * E
        for t in range(g0, min(T, g0 + group)):
            for j in range(k):
                e = int(idx[t, j])
                fill[e] += 1
                n += bool(valid[t]) and fill[e] > C
    return n


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_counters_count_valid_rows_and_true_drops(cf):
    cfg = _cfg(capacity_factor=cf)
    p = _moe(cfg)
    x = _x((4, 9, cfg.d_model), 6)
    valid = torch.arange(9)[None, :] < torch.tensor([9, 4, 0, 7])[:, None]
    _, idx, _ = M.router_topk(p, x.reshape(-1, cfg.d_model), cfg)
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    C = max(1, int(36 * k * cf / E))
    want = _gshard_drops(idx, valid.reshape(-1), k, E, C, 36)
    with M.counting("cpu") as acc:
        M.apply_moe_gshard(p, x, cfg, valid=valid)
    assert acc.tolist()[0] == int(valid.sum()) * k
    assert acc.tolist()[3] == want
    with M.counting("cpu") as acc:
        y, _ = M.apply_moe_grouped(p, x, cfg, valid)
    routed, hit, most, dropped = acc.tolist()
    per_e = torch.bincount(idx[valid.reshape(-1)].reshape(-1), minlength=E)
    assert (routed, hit, most, dropped) == (
        int(valid.sum()) * k, int((per_e > 0).sum()), int(per_e.max()), 0)
    # an invalid row's routed output is zero: its shared experts' alone
    sh = M._shared(p, x, cfg)
    assert torch.equal(y[~valid], sh[~valid])


def test_grouped_model_takes_prefill_rows_with_the_whole_chunks_tokens():
    cfg = _cfg(serve_impl="grouped")
    fns = build_serve_fns(cfg, batch=4, max_len=48, prefill_chunk=16,
                          device="cpu")
    assert fns.prefill_rows is not None
    assert build_serve_fns(_cfg(), batch=4, max_len=48, prefill_chunk=16,
                           device="cpu").prefill_rows is None
    module = fns.init_params(0)
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(1, cfg.vocab_size, (4, 16), generator=g,
                         dtype=torch.int32)
    first = torch.randint(1, cfg.vocab_size, (4, 16), generator=g,
                          dtype=torch.int32)
    lengths = torch.tensor([16, 9, 16, 5], dtype=torch.int32)
    valid_n = torch.tensor([0, 12, 0, 7], dtype=torch.int32)
    cache = fns.init_cache()
    fns.prefill_chunk(module, cache, first, torch.zeros(4, dtype=torch.int32),
                      lengths)
    whole = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    want, want_last, _ = fns.prefill_chunk(module, whole, toks, lengths,
                                           valid_n)
    s = torch.tensor([1, 3])
    got, got_last, _ = fns.prefill_rows(module, cache, s, toks, lengths,
                                        valid_n)
    assert torch.equal(got, want[s])
    assert (got_last - want_last[s]).abs().max().item() <= 1e-4


def test_a_mesh_refuses_the_grouped_dispatch():
    with pytest.raises(NotImplementedError, match="one device"):
        build_serve_fns(_cfg(serve_impl="grouped"), mesh=object(), batch=4,
                        max_len=48, device="cpu")


@pytest.mark.parametrize("impl", ["grouped", "gshard"])
@pytest.mark.parametrize("trace", [True, False])
def test_the_engines_tracing_records_the_counters(impl, trace, monkeypatch):
    """With ``EngineConfig.trace`` each prefill and decode call records
    one row of counts under its ``executor.*`` span and each MoE layer a
    ``moe.route`` span; ``grouped`` drops nothing.  Without tracing no
    counter tensor is made."""
    from repro_torch.api.runtime import ServeRuntime
    from repro_torch.core.slo import SLOPolicy
    from repro_torch.serving.request import Request
    cfg = _cfg(serve_impl=impl)
    n_moe = sum(cfg.moe_layer_mask())
    made = []
    real = M.counting

    def spy(device):
        made.append(device)
        return real(device)

    monkeypatch.setattr(M, "counting", spy)
    ecfg = EngineConfig(max_tenants=2, max_slots=4, max_len=64,
                        prefill_chunk=16, trace=trace)
    rt = ServeRuntime(ecfg, executor=ModelExecutor(cfg, ecfg, device="cpu"))
    rt.create_tenant(0, SLOPolicy(kv_quota_tokens=4 * 64))
    rng = np.random.default_rng(3)
    rt.inject([Request(0, rng.integers(1, 200, n).astype(np.int32),
                       max_new_tokens=4) for n in (20, 7, 33)])
    for _ in range(12):
        rt.engine.step()
    if not trace:
        assert made == []
        return
    tr = rt.engine.trace
    rows = tr.moe_rows()
    host = tr.host_rows()
    calls = host["id"][np.isin(host["name"], ["executor.prefill",
                                              "executor.decode"])]
    assert len(rows["call"]) == len(calls) == len(made) > 0
    assert set(rows["call"]) == set(calls)
    assert (rows["routed"] > 0).all()
    assert (rows["routed"] % (cfg.moe.top_k * n_moe) == 0).all()
    assert (rows["experts_hit"] <= n_moe * cfg.moe.num_experts).all()
    if impl == "grouped":
        assert (rows["dropped"] == 0).all()
    assert (host["name"] == "moe.route").sum() == n_moe * len(calls)
