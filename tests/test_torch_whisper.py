"""The port's encoder-decoder (whisper-large-v3) against the JAX
package's, from the same weights: the encoder over stub frame
embeddings (non-causal self-attention, sinusoidal positions), the
decoder's causal self-attention and its cross-attention over every
encoder frame, the serving cache's cross K/V and AdamW training.

Smoke size (2 encoder + 2 decoder layers, 16 frames), float32: logits at
1e-4 (``_torch_parity``), greedy tokens and the engine's RunReport
equal.  The reference runs ``chunked``: under ``pallas`` its one-token
cross decode attends no frame (fill 0), which the port does not copy.
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
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.training import data as jdata
from repro.training.trainer import build_trainer as jax_build_trainer
from repro_torch.configs import get_config, param_count
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model
from repro_torch.training.trainer import build_trainer
from repro_torch.weights import (named_arrays, params_from_jax,
                                 train_state_from_reference)

ARCH = "whisper-large-v3"
T_ENC, D_MODEL = 16, 64          # the smoke config's frames and width


@pytest.fixture(scope="module")
def ref():
    return P.ref_params(ARCH)


def frames(B, seed, T=T_ENC):
    return np.random.default_rng(seed).standard_normal(
        (B, T, D_MODEL)).astype(np.float32)


@pytest.mark.parametrize("S", [24, T_ENC])
@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_forward_logits_match(ref, port_impl, S, monkeypatch):
    """Cache-free logits with random frames; under ``pallas`` every
    encoder layer and every decoder self-attention takes the flash entry
    point, and the cross-attention too when the decoder's length is the
    frames' (16)."""
    jparams, np_tree = ref
    calls = P.count_calls(monkeypatch, tops, "flash_attention",
                          "decode_attention")
    batch = {"frames": frames(2, seed=1), "tokens": P.tokens((2, S), 257, 2)}
    (want, jaux), (got, aux) = P.forward_pair(ARCH, jparams, np_tree,
                                              port_impl, batch)
    P.close(got, want, "logits")
    assert aux == 0.0 == jaux
    n_flash = 2 + 2 + (2 if S == T_ENC else 0)
    assert calls == (["flash_attention"] * n_flash
                     if port_impl == "pallas" else [])


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_encoder_output_and_cross_kv_match(ref, port_impl):
    """``encode`` alone, and ``prepare_cross``'s per-layer K/V, against
    the reference's stacked (layers, B, T, H, D) arrays."""
    jparams, np_tree = ref
    jcfg, tcfg = P.cfgs(ARCH, port_impl)
    fr = frames(3, seed=3)
    want = JE.encode(jparams, jcfg, jnp.asarray(fr))
    wk, wv = JE.prepare_cross(jparams, jcfg, want)
    module = params_from_jax(np_tree, tcfg)
    with torch.no_grad():
        got = module.encode(torch.from_numpy(fr))
        cross = module.prepare_cross(got)
    P.close(got.numpy(), want, "encoder output")
    assert len(cross) == tcfg.num_layers
    for i, (k, v) in enumerate(cross):
        assert k.shape == (3, T_ENC, 4, 16) and k.is_contiguous()
        P.close(k.numpy(), wk[i], f"xk {i}")
        P.close(v.numpy(), wv[i], f"xv {i}")


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_ragged_prefill_with_frames_then_decode_match(ref, port_impl,
                                                     monkeypatch):
    """Random frames with the first of ragged prefill chunks (prompts of
    29 and 17 in chunks of 12), then 12 decode steps, each through the
    decode entry point twice a layer under ``pallas`` (self, then cross
    with fill 16 in every row)."""
    jparams, np_tree = ref
    fills = []
    real = tops.decode_attention
    monkeypatch.setattr(tops, "decode_attention", lambda q, k, v, n, **kw: (
        fills.append((k.shape[1], n.tolist())), real(q, k, v, n, **kw))[1])
    cache = P.check_pairs(P.prefill_then_decode(
        ARCH, jparams, np_tree, port_impl, [29, 17], C=12, steps=12,
        frames=frames(2, seed=4)))
    if port_impl == "pallas":
        assert len(fills) == 2 * 2 * 12
        assert all(n == [T_ENC, T_ENC] for t, n in fills[1::2])
        assert all(t == P.MAX_LEN for t, _ in fills[::2])
    else:
        assert fills == []
    assert all(c["xk"].abs().max() > 0 for c in cache)


@pytest.mark.parametrize("wrong_fill", [0, 1])
def test_a_wrong_cross_fill_fails_the_decode_check(ref, wrong_fill,
                                                   monkeypatch):
    """The decode check above sees the cross fill: with the JAX package's
    Pallas fill (0: no frame) or ``_run_attention``'s q_pos + 1 over the
    cross call's zero query positions (1: frame 0 alone) the port's
    decode logits leave the reference's by far more than the
    tolerance."""
    jparams, np_tree = ref
    real = tops.decode_attention

    def mutant(q, k, v, n, **kw):
        if k.shape[1] == T_ENC:                 # the cross call
            n = torch.full_like(n, wrong_fill)
        return real(q, k, v, n, **kw)
    monkeypatch.setattr(tops, "decode_attention", mutant)
    gaps = [np.abs(got - want).max() for what, want, got in
            P.prefill_then_decode(ARCH, jparams, np_tree, "pallas", [29, 17],
                                  C=12, steps=2, frames=frames(2, seed=4))
            if what.startswith("decode") and "tokens" not in what]
    assert gaps and min(gaps) > 100 * P.TOL, gaps


def test_engine_report_matches():
    """``serve_mixed_slo`` on both engines over the zero cross K/V the
    engine serves with: per-tenant results, EQ events, every request's
    generated tokens and the RunReport JSON."""
    jrt, jrep, trt, trep = P.run_model_engines(ARCH)
    assert sum(r.completed for r in trep.tenants.values()) == 6
    assert trep.to_json() == jrep.to_json()
    assert trep.events == jrep.events
    jdone = sorted(jrt.engine.done, key=lambda r: r.rid)
    tdone = sorted(trt.engine.done, key=lambda r: r.rid)
    assert [(r.rid, r.status.value, r.generated) for r in tdone] == \
        [(r.rid, r.status.value, r.generated) for r in jdone]


def test_reset_slots_keeps_the_cross_kv():
    """A reassigned slot gets a fresh self-attention cache; the cross
    K/V rows, which no reset touches, stay as they were."""
    cache = P.check_reset_slots(ARCH)
    assert all(set(c) == {"k", "v", "pos", "xk", "xv"} for c in cache)
    assert all(not c["xk"].any() and not c["xv"].any() for c in cache)


def test_param_count_and_configs_match(ref):
    """The port's parameters number ``param_count(cfg)`` and the
    reference's; its configs, smoke and full, are the reference's."""
    _, np_tree = ref
    jcfg, tcfg = P.cfgs(ARCH, "pallas")
    module = params_from_jax(np_tree, tcfg)
    n = sum(p.numel() for p in module.parameters())
    assert n == param_count(tcfg) == sum(
        a.size for a in jax.tree.leaves(np_tree))
    assert P.as_reference(tcfg) == dataclasses.asdict(
        dataclasses.replace(jcfg, attn_impl="pallas"))
    assert P.as_reference(get_config(ARCH)) == dataclasses.asdict(
        jax_get_config(ARCH))
    assert param_count(get_config(ARCH)) == jax_param_count(
        jax_get_config(ARCH)) == 1_954_032_640


@pytest.mark.parametrize("positions", [[0, 1, 15], [-1, 448, 65535, 70000]])
def test_sinusoidal_rows_match_the_table(positions):
    """The decoder's rows, computed where they are read, against rows of
    the reference's 65,536-row table (clipped: -1 reads row 0)."""
    pos = np.asarray([positions], np.int32)
    table = JL.sinusoidal_positions(1 << 16, D_MODEL)
    want = jnp.take(table, jnp.clip(jnp.asarray(pos), 0, (1 << 16) - 1),
                    axis=0)
    got = L.sinusoidal_at(torch.from_numpy(pos), D_MODEL)
    P.close(got.numpy(), want, "rows", tol=1e-6)
    P.close(L.sinusoidal_positions(T_ENC, D_MODEL).numpy(),
            JL.sinusoidal_positions(T_ENC, D_MODEL), "table", tol=1e-6)


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_train_steps_match_the_jax_trainer(port_impl, monkeypatch):
    """Three AdamW steps from the reference's initial state, batches with
    random frames: losses, grad norms and parameters as the JAX
    trainer's (which trains under ``chunked``).  Under ``pallas`` the
    encoder's non-causal and the decoder's causal attention run the
    flash entry point, forward and backward (the plain versions here)."""
    jcfg, tcfg = P.cfgs(ARCH, port_impl)
    calls = P.count_calls(monkeypatch, tops, "flash_attention")
    kw = dict(total_steps=10, warmup_steps=2)
    src = jdata.SyntheticLM(jcfg, 24, 4, seed=0)
    batches = [dict(next(src), frames=frames(4, seed=10 + i))
               for i in range(3)]
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
    assert len(calls) == (3 * (2 + 2) if port_impl == "pallas" else 0)


def test_prefill_frames_replace_the_cross_kv():
    """``prefill(frames=...)`` fills every layer's xk / xv with
    ``prepare_cross``'s, in the cache's shape; without frames the
    decoder serves over the zero cross K/V of ``init_cache``."""
    _, tcfg = P.cfgs(ARCH, "pallas")
    model = build_model(tcfg)
    module = model.init(torch.Generator().manual_seed(0))
    fr = torch.from_numpy(frames(2, seed=5))
    toks = torch.from_numpy(P.tokens((2, 4), 257, 6))
    zero = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        cache = model.init_cache(2, 32, "cpu")
        assert all(not c["xk"].any() for c in cache)
        with_frames, cache = model.prefill(module, toks, cache, zero,
                                           frames=fr)
        want = module.prepare_cross(module.encode(fr))
        bare, _ = model.prefill(module, toks, model.init_cache(2, 32, "cpu"),
                                zero)
    for c, (k, v) in zip(cache, want):
        assert c["xk"].shape == (2, T_ENC, 4, 16)
        torch.testing.assert_close(c["xk"], k, atol=0, rtol=0)
        torch.testing.assert_close(c["xv"], v, atol=0, rtol=0)
    assert (with_frames - bare).abs().max() > 1e-3


def test_serve_cli_serves_the_smoke_model_on_the_cpu(capsys):
    """``launch.serve --arch whisper-large-v3 --smoke --device cpu``
    serves every request; without ``--device cpu`` it asks for the card,
    which is not here."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "6"]
    assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("killed=0") == 3 and "done=0" not in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.main(argv)
