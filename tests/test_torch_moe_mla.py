"""The port's MoE and MLA decoders against the JAX package's, from the
same weights: DeepSeek-V2-Lite (a dense first layer, then MoE layers of
routed and shared experts, multi-head latent attention) and Llama-4
Maverick (MoE every second layer, top-1 routing, one shared expert).

Smoke sizes, float32: logits at 1e-4 (``_torch_parity``), the MoE aux
loss at 1e-6, greedy tokens and the engine's RunReport equal.  The
engine and the serving steps run ``gshard`` (its capacity drops decide
the tokens), the models' default forward ``ragged``, as in the JAX
package.
"""
import dataclasses

import numpy as np
import pytest
import torch

# the card's machine has no JAX: there this module, which holds no
# ``gpu`` test, skips as a whole
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import _torch_parity as P
from repro.configs import get_config as jax_get_config
from repro.configs import param_count as jax_param_count
from repro.models import moe as JM
from repro.models.registry import build_model as jax_build_model
from repro.training import data as jdata
from repro.training.trainer import build_trainer as jax_build_trainer
from repro_torch.configs import get_config, param_count
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as M
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.training.trainer import build_trainer
from repro_torch.weights import (named_arrays, params_from_jax,
                                 train_state_from_reference)

ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]
DEEPSEEK = "deepseek-v2-lite-16b"
AUX_TOL = 1e-6


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return (request.param,) + P.ref_params(request.param)


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_forward_logits_match(ref, port_impl):
    """Cache-free logits and aux loss over 40 tokens (the default
    ``ragged`` dispatch; MLA's expanded path)."""
    arch, jparams, np_tree = ref
    toks = P.tokens((2, 40), 257, seed=1)
    (want, jaux), (got, aux) = P.forward_pair(arch, jparams, np_tree,
                                              port_impl, {"tokens": toks})
    P.close(got, want, "logits")
    assert abs(float(aux) - float(jaux)) < AUX_TOL
    assert float(aux) > 0


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_ragged_prefill_then_decode_match(ref, port_impl, monkeypatch):
    """Prompts of 29 and 17 tokens in chunks of 12, then 8 decode steps;
    MLA's absorbed path (K dim rank + rope, V dim rank) takes the plain
    path under ``pallas`` too, so DeepSeek never calls the decode kernel,
    and Llama-4 calls it once a layer a step."""
    arch, jparams, np_tree = ref
    calls = P.count_calls(monkeypatch, tops, "decode_attention")
    P.check_pairs(P.prefill_then_decode(arch, jparams, np_tree, port_impl,
                                        [29, 17], C=12, steps=8))
    tcfg = P.cfgs(arch, port_impl)[1]
    want = 8 * tcfg.num_layers if (port_impl == "pallas"
                                   and tcfg.mla is None) else 0
    assert len(calls) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_report_matches(arch):
    """``serve_mixed_slo`` on both engines (``gshard``: inactive slots
    and chunk tails take expert capacity too): per-tenant results, EQ
    events, every request's generated tokens and the RunReport JSON."""
    jrt, jrep, trt, trep = P.run_model_engines(arch)
    assert sum(r.completed for r in trep.tenants.values()) == 6
    assert trep.to_json() == jrep.to_json()
    assert trep.events == jrep.events
    jdone = sorted(jrt.engine.done, key=lambda r: r.rid)
    tdone = sorted(trt.engine.done, key=lambda r: r.rid)
    assert [(r.rid, r.status.value, r.generated) for r in tdone] == \
        [(r.rid, r.status.value, r.generated) for r in jdone]


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slots_gives_a_reassigned_slot_a_fresh_cache(arch):
    """For MLA the cache is ``ckv`` / ``krope`` / ``pos``: the payloads
    stay and are masked by the cleared positions."""
    cache = P.check_reset_slots(arch)
    if arch == DEEPSEEK:
        assert set(cache[0]) == {"ckv", "krope", "pos"}


def test_param_count_matches_the_formula(ref):
    """The port's parameters (router, stacked experts, shared experts,
    MLA projections, untied head) number ``param_count(cfg)``; its
    configs, smoke and full, are the reference's."""
    arch, _, np_tree = ref
    jcfg, tcfg = P.cfgs(arch, "pallas")
    module = params_from_jax(np_tree, tcfg)
    assert sum(p.numel() for p in module.parameters()) == param_count(tcfg)
    assert P.as_reference(tcfg) == dataclasses.asdict(
        dataclasses.replace(jcfg, attn_impl="pallas"))
    assert P.as_reference(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert param_count(get_config(arch)) == jax_param_count(
        jax_get_config(arch))


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------
def _moe_pair(arch=DEEPSEEK, **moe_changes):
    """(cfg, reference MoE params, the port's ``MoE`` holding them)."""
    _, cfg = P.cfgs(arch, "chunked", param_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **moe_changes))
    jcfg = P.cfgs(arch, "chunked", param_dtype="float32")[0]
    jcfg = dataclasses.replace(jcfg, moe=cfg.moe)
    jparams = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    flat = {}
    for k, v in jparams.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    module = M.MoE(cfg, torch.Generator().manual_seed(0))
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in flat.items()}, strict=True)
    return jcfg, cfg, jparams, module


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair_out(jout, tout):
    return ([np.asarray(jout[0]), float(jout[1])],
            [tout[0].numpy(), float(tout[1])])


def test_router_topk_matches():
    jcfg, cfg, jparams, module = _moe_pair()
    x = _x((30, 64), seed=1)
    jw, jidx, jaux = JM.router_topk(jparams, jnp.asarray(x), jcfg)
    w, idx, aux = M.router_topk(module, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    P.close(w.numpy(), jw, "weights", tol=1e-6)
    assert abs(float(aux) - float(jaux)) < AUX_TOL


def test_router_ties_go_to_the_lower_expert():
    """With a zero router every expert ties: ``jax.lax.top_k`` takes the
    lowest indices first, and so must the port."""
    jcfg, cfg, jparams, module = _moe_pair()
    jparams = dict(jparams, router=jnp.zeros_like(jparams["router"]))
    with torch.no_grad():
        module.router.zero_()
    x = _x((6, 64), seed=2)
    _, jidx, _ = JM.router_topk(jparams, jnp.asarray(x), jcfg)
    _, idx, _ = M.router_topk(module, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(2), (6, 1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_gshard_with_drops_matches(arch):
    """``capacity_factor`` 0.5: C = int(T * k * 0.5 / E), so tokens past
    an expert's capacity drop; which ones depends on the (token, choice)
    queue order, and the port must drop the reference's."""
    jcfg, cfg, jparams, module = _moe_pair(arch)
    x = _x((2, 16, 64), seed=3)
    want, got = _pair_out(
        JM.apply_moe_gshard(jparams, jnp.asarray(x), jcfg,
                            capacity_factor=0.5),
        M.apply_moe_gshard(module, torch.from_numpy(x), cfg,
                           capacity_factor=0.5))
    P.close(got[0], want[0], "y")
    assert abs(got[1] - want[1]) < AUX_TOL
    roomy, _ = M.apply_moe_gshard(module, torch.from_numpy(x), cfg,
                                  capacity_factor=8.0)
    assert np.abs(roomy.numpy() - got[0]).max() > 1e-3   # drops happened


@pytest.mark.parametrize("arch", ARCHS)
def test_gshard_padded_groups_match(arch):
    """T = 42 in groups of 16: the last group is padded with 6 rows of
    expert -1, never kept; with room for every token the grouping does
    not change the output."""
    jcfg, cfg, jparams, module = _moe_pair(arch, capacity_factor=8.0)
    x = _x((2, 21, 64), seed=4)
    want, got = _pair_out(
        JM.apply_moe_gshard(jparams, jnp.asarray(x), jcfg, group_size=16),
        M.apply_moe_gshard(module, torch.from_numpy(x), cfg, group_size=16))
    P.close(got[0], want[0], "y")
    assert abs(got[1] - want[1]) < AUX_TOL
    big, _ = M.apply_moe_gshard(module, torch.from_numpy(x), cfg,
                                group_size=4096)
    P.close(got[0], big.numpy(), "group 16 vs one group")


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_matches(arch):
    """Sort by expert + one product per expert; no capacity, no drops;
    and with room for every token gshard gives the same output."""
    jcfg, cfg, jparams, module = _moe_pair(arch, capacity_factor=8.0)
    x = _x((2, 16, 64), seed=5)
    want, got = _pair_out(
        JM.apply_moe_ragged(jparams, jnp.asarray(x), jcfg),
        M.apply_moe_ragged(module, torch.from_numpy(x), cfg))
    P.close(got[0], want[0], "y")
    assert abs(got[1] - want[1]) < AUX_TOL
    gs, _ = M.apply_moe(module, torch.from_numpy(x), cfg, "gshard")
    P.close(gs.numpy(), got[0], "gshard vs ragged")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("moe_impl", M.MOE_IMPL)
def test_mla_absorbed_prefill_matches_expanded(moe_impl):
    """DeepSeek MLA: the absorbed (latent MQA, with a cache) prefill
    agrees with the expanded cache-free forward on the same tokens
    (5e-3, as the reference's own test), and both agree with the
    reference's."""
    jparams, np_tree = P.ref_params(DEEPSEEK)
    jcfg, tcfg = P.cfgs(DEEPSEEK, "pallas")
    toks = P.tokens((2, 12), 257, seed=6)
    model = build_model(tcfg, moe_impl=moe_impl)
    module = params_from_jax(np_tree, tcfg)
    with torch.no_grad():
        expanded, _ = model.forward(module, {"tokens": torch.from_numpy(toks)})
        absorbed, _ = model.prefill(module, torch.from_numpy(toks),
                                    model.init_cache(2, 32, "cpu"),
                                    torch.zeros(2, dtype=torch.int32))
    assert (absorbed - expanded).abs().max().item() < 5e-3
    jm = jax_build_model(jcfg, moe_impl=moe_impl)
    want, _ = jm.prefill(jparams, jnp.asarray(toks), jm.init_cache(2, 32),
                         jnp.zeros(2, jnp.int32))
    P.close(absorbed.numpy(), want, "absorbed prefill")


def test_serving_steps_run_gshard(monkeypatch):
    """The serving steps dispatch with ``gshard``, as the JAX package's
    do; the models' default forward with ``ragged``."""
    seen = P.count_calls(monkeypatch, M, "apply_moe_gshard",
                         "apply_moe_ragged")
    _, tcfg = P.cfgs(DEEPSEEK, "pallas")
    fns = build_serve_fns(tcfg, batch=2, max_len=P.MAX_LEN, device="cpu")
    module = fns.init_params(0)
    toks = torch.from_numpy(P.tokens((2, 8), 257, seed=7))
    fns.prefill_chunk(module, fns.init_cache(), toks,
                      torch.zeros(2, dtype=torch.int32),
                      torch.full((2,), 8, dtype=torch.int32))
    assert seen == ["apply_moe_gshard"]
    seen.clear()
    with torch.no_grad():
        build_model(tcfg).forward(module, {"tokens": toks})
    assert seen == ["apply_moe_ragged"]


def test_train_steps_match_the_jax_trainer():
    """Three AdamW steps of the DeepSeek smoke model (``gshard``; the
    loss carries the MoE aux term, 1e-2 * aux / num_layers) from the
    reference's initial state: losses, grad norms and parameters as the
    JAX trainer's."""
    jcfg, tcfg = P.cfgs(DEEPSEEK, "chunked")
    kw = dict(total_steps=10, warmup_steps=2)
    src = jdata.SyntheticLM(jcfg, 32, 4, seed=0)
    batches = [next(src) for _ in range(3)]
    jtr = jax_build_trainer(jcfg, donate=False, **kw)
    js = jtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, js)
    want = []
    for b in batches:
        js, m = jtr.train_step(js, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    tr = build_trainer(tcfg, device="cpu", **kw)
    state = train_state_from_reference(init.params, init.opt_state,
                                       init.step, tcfg)
    got = []
    for b in batches:
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-4)
    ref_params = named_arrays(jax.tree.map(np.asarray, js.params), tcfg)
    for k, p in state.named_params().items():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[k],
                                   atol=2e-5, rtol=0, err_msg=k)
