"""The port's dense and vision-language decoders against the JAX
package's, from the same weights: CodeQwen1.5-7B (QKV bias, untied
head), Gemma-7B (head dim 256 with one query head per KV head at full
size, GeGLU, scaled embeddings), Gemma2-27B (alternating local and
global layers, soft-caps, post-norms, a query scale of its own) and
Qwen2-VL-72B (M-RoPE, the vision-embedding splice, untied head).

Smoke sizes, float32: logits at 1e-4 (``_torch_parity``), greedy tokens
and the engine's RunReport equal.
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
from repro.models import layers as JL
from repro_torch.configs import LOCAL_ATTN, get_config, param_count
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as L
from repro_torch.weights import params_from_jax

ARCHS = ["codeqwen1.5-7b", "gemma-7b", "gemma2-27b", "qwen2-vl-72b"]
VL = "qwen2-vl-72b"
# the smoke config's 8 frequencies all read M-RoPE's first section (the
# reference cuts (16, 24, 24) to head_dim / 2): sections that fill 8
SECTIONS = (2, 3, 3)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return (request.param,) + P.ref_params(request.param)


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_forward_logits_match(ref, port_impl, monkeypatch):
    """Cache-free logits over 40 tokens (past Gemma2's 32-token smoke
    window); under ``pallas`` every layer takes the flash entry point."""
    arch, jparams, np_tree = ref
    calls = P.count_calls(monkeypatch, tops, "flash_attention")
    toks = P.tokens((2, 40), 257, seed=1)
    (want, jaux), (got, aux) = P.forward_pair(arch, jparams, np_tree,
                                              port_impl, {"tokens": toks})
    P.close(got, want, "logits")
    assert aux == 0.0 == jaux
    n_layers = P.cfgs(arch, port_impl)[1].num_layers
    assert len(calls) == (n_layers if port_impl == "pallas" else 0)


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_ragged_prefill_then_decode_match(ref, port_impl, monkeypatch):
    """Prompts of 29 and 17 tokens in chunks of 12: every chunk is ragged
    in one row, then 20 decode steps, each through the decode entry
    point under ``pallas``; Gemma2's local layers' caches are rings of 32
    entries, which the 49-token row wraps."""
    arch, jparams, np_tree = ref
    calls = P.count_calls(monkeypatch, tops, "decode_attention")
    cache = P.check_pairs(P.prefill_then_decode(
        arch, jparams, np_tree, port_impl, [29, 17], C=12, steps=20))
    tcfg = P.cfgs(arch, port_impl)[1]
    assert len(calls) == (20 * tcfg.num_layers if port_impl == "pallas"
                          else 0)
    kinds = tcfg.pattern_for_layers()
    if LOCAL_ATTN in kinds:
        ring = cache[kinds.index(LOCAL_ATTN)]
        assert ring["pos"].shape[1] == 32
        assert int(ring["pos"].max()) == 48      # wrapped: position 48 at 16


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_report_matches(arch):
    """``serve_mixed_slo`` on both engines: per-tenant results, EQ
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
    P.check_reset_slots(arch)


def test_param_count_matches_the_formula(ref):
    """The port's parameters (untied heads included) number
    ``param_count(cfg)``; its configs, smoke and full, are the
    reference's."""
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


@pytest.mark.parametrize("sections,head_dim", [
    ((16, 24, 24), 128),        # Qwen2-VL-72B's own
    ((16, 24, 24), 16),         # cut to the smoke head dim: all stream t
    (SECTIONS, 16),
    ((1, 2), 16),               # short: the last section fills the rest
])
def test_rope_angles_with_three_streams_match(sections, head_dim):
    """M-RoPE: each frequency reads its section's position stream; three
    different streams, so a wrong section shows."""
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 4000, size=(3, 2, 7)).astype(np.int32)
    want = JL.rope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    got = L.rope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    P.close(got.numpy(), want, "angles", tol=1e-6)
    # and a (3, B, S) input without sections reads the first stream
    got0 = L.rope_angles(torch.from_numpy(pos), head_dim, 1e6)
    torch.testing.assert_close(got0, L.rope_angles(
        torch.from_numpy(pos[0]), head_dim, 1e6), atol=0, rtol=0)


@pytest.mark.parametrize("port_impl", P.IMPLS)
def test_vis_splice_with_three_position_streams_matches(port_impl):
    """Qwen2-VL's forward with precomputed patch embeddings spliced in
    where ``vis_mask`` is set, and three different (t, h, w) position
    streams whose sections fill the smoke head dim."""
    jparams, np_tree = P.ref_params(VL, mrope_sections=SECTIONS)
    rng = np.random.default_rng(6)
    B, S = 2, 24
    batch = {
        "tokens": P.tokens((B, S), 257, seed=7),
        "positions": np.stack([np.arange(S)[None].repeat(B, 0),
                               rng.integers(0, 9, (B, S)),
                               rng.integers(0, 9, (B, S))]).astype(np.int32),
        "vis_embeds": rng.standard_normal((B, S, 64)).astype(np.float32),
        "vis_mask": rng.random((B, S)) < 0.5,
    }
    (want, _), (got, _) = P.forward_pair(VL, jparams, np_tree, port_impl,
                                         batch, mrope_sections=SECTIONS)
    P.close(got, want, "logits")
    # the splice and the streams both move the logits
    for drop in ("vis_embeds", "positions"):
        rest = {k: v for k, v in batch.items()
                if k not in (drop, "vis_mask" if drop == "vis_embeds"
                             else "")}
        (_, _), (other, _) = P.forward_pair(VL, jparams, np_tree, port_impl,
                                            rest, mrope_sections=SECTIONS)
        assert np.abs(other - got).max() > 1e-3, drop
