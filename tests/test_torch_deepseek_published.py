"""DeepSeek-V2 as published, served through ``ModelExecutor`` at a small
published-shaped size on the CPU, against the benchmark's plain
reference (``portbench/reference/mla_moe.py``) on the same seeded
random weights.

The configuration keeps every published mechanism at small widths: 3
layers (the first dense, then 2 MoE layers of 8 routed experts, top-2,
plus a shared expert), MLA with a rope part of 16 dims, YaRN at factor
40 from an ``original_max_position`` of 64 (the frequency ramp spans
dims 0-3 of the 8: extrapolated, two between, then interpolated), and
top-k weights left unnormalised.  Prompts of 70-90 tokens run past the
original 64 positions.  The program prefills them in chunks of 16, some
calls with rows that have no work (``prefill_rows``), then decodes
through the latent cache with the dropless ``grouped`` dispatch; every
logit it samples from is held to the reference's full forward.

Three mutants of the program must each fail that comparison: the softmax
scale without YaRN's mscale^2, the top-k weights renormalised, and the
YaRN frequencies off.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import mla_moe as REF  # noqa: E402
from portbench.reference.common import Precision  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import serve_step as SS  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ModelExecutor  # noqa: E402

PUB = {
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "kv_lora_rank": 32, "max_position_embeddings": 2560,
    "model_type": "deepseek_v2", "moe_intermediate_size": 32,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 8,
    "n_shared_experts": 1, "norm_topk_prob": False,
    "num_attention_heads": 4, "num_experts_per_tok": 2,
    "num_hidden_layers": 3, "num_key_value_heads": 4, "q_lora_rank": None,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "rms_norm_eps": 1e-6,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 64,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "v_head_dim": 16, "vocab_size": 257}
PROMPTS = [70, 90, 81]
C, STEPS, MAX_LEN = 16, 6, 128
# fp32 on both sides; what differs is the order of the sums (the latent
# cache's absorbed attention against the reference's expanded heads,
# chunked prefill, grouped products): rounding, ~1e-6 of a logit range
# of several units.  A mutant moves logits by tenths.
TOL = 2e-4


def _cfg(**moe):
    base = get_config("deepseek-v2-lite-16b")
    fields = REF.port_fields(PUB)
    fields["moe"] = dict(fields["moe"], **moe)
    for k, v in list(fields.items()):
        if isinstance(v, dict):
            fields[k] = dataclasses.replace(getattr(base, k), **v)
    return dataclasses.replace(base, dtype="float32", param_dtype="float32",
                               attn_impl="pallas", **fields)


def _weights():
    # the reference's bf16 draw, held in fp32 by the fp32 module: both
    # sides read the same values
    return {k: v.float() for k, v in REF.draw(PUB, 11, "cpu").items()}


def _serve(cfg, W, monkeypatch):
    """Prefill the prompts in chunks through ``ModelExecutor`` (slot 2
    starts a chunk late, so calls carry rows with no work), then decode
    ``STEPS`` tokens (slot 0 sits out one step).  Returns the prompts,
    the tokens each slot served and the logits each was sampled from."""
    from portbench.harness.bench import bind
    seen = []
    real = SS.sample

    def spy(logits, **kw):
        seen.append(logits.clone())
        return real(logits, **kw)

    monkeypatch.setattr(SS, "sample", spy)
    module = build_model(cfg).init(L.generator("meta", 0))
    bind(module, W)
    ecfg = EngineConfig(max_slots=3, max_len=MAX_LEN, prefill_chunk=C)
    exe = ModelExecutor(cfg, ecfg, params=module, device="cpu")
    assert exe.fns.prefill_rows is not None
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, PUB["vocab_size"], n).astype(np.int32)
               for n in PROMPTS]
    start = [0, 0, 1]                 # the chunk each slot starts at
    served = [[] for _ in prompts]
    logits = [[] for _ in prompts]
    done = [0] * 3
    for call in range(max(-(-n // C) + s for n, s in zip(PROMPTS, start))):
        toks = np.zeros((3, C), np.int32)
        valid = np.zeros(3, np.int32)
        for b, p in enumerate(prompts):
            if call >= start[b] and done[b] < len(p):
                n = min(C, len(p) - done[b])
                toks[b, :n] = p[done[b]:done[b] + n]
                valid[b] = n
        seen.clear()
        out = exe.prefill(toks, np.array(done, np.int32), valid)
        rows = np.flatnonzero(valid > 0)
        last = seen[0] if len(rows) < 3 else seen[0][rows]
        for j, b in enumerate(rows):
            done[b] += valid[b]
            if done[b] == len(prompts[b]):
                served[b].append(int(out[b]))
                logits[b].append(last[j])
    lengths = np.array(done, np.int32)
    for step in range(STEPS):
        active = np.ones(3, bool)
        active[0] = step != 2
        seen.clear()
        tok = np.array([s[-1] for s in served], np.int32)
        out = exe.decode(tok, lengths, active)
        for b in np.flatnonzero(active):
            served[b].append(int(out[b]))
            logits[b].append(seen[0][b])
        lengths = lengths + active
    return prompts, served, logits


def _worst(cfg, W, monkeypatch) -> float:
    """The largest gap between a served logit and the reference's at the
    same position, over the logit range."""
    prompts, served, logits = _serve(cfg, W, monkeypatch)
    worst = 0.0
    for p, s, lg in zip(prompts, served, logits):
        seq = torch.as_tensor(np.concatenate([p, s[:-1]]).astype(np.int64))
        want = REF.logits(W, PUB, seq, len(p) - 1, Precision("fp32"))
        got = torch.stack(lg).float()
        assert got.shape == want.shape
        worst = max(worst, ((got - want).abs().max()
                            / want.abs().max()).item())
    return worst


def test_served_logits_match_the_published_reference(monkeypatch):
    W = _weights()
    assert _worst(_cfg(), W, monkeypatch) <= TOL


def _no_mscale(monkeypatch, cfg):
    # YaRN's attention temperature gone: the scale is 1/sqrt(192) alone
    # (cos and sin keep their factor, mscale over mscale_all_dim, 1 here)
    monkeypatch.setattr(L, "yarn_mscale", lambda factor, m: 1.0)
    return cfg


def _renormalised(monkeypatch, cfg):
    return _cfg(norm_topk_prob=True)


def _no_yarn_freqs(monkeypatch, cfg):
    real = L.rope_freqs
    monkeypatch.setattr(L, "rope_freqs",
                        lambda hd, theta, dev, yarn=None: real(hd, theta,
                                                               dev))
    return cfg


@pytest.mark.parametrize("mutant", [_no_mscale, _renormalised,
                                    _no_yarn_freqs])
def test_each_mutant_of_the_published_function_fails(monkeypatch, mutant):
    W = _weights()
    cfg = mutant(monkeypatch, _cfg())
    assert _worst(cfg, W, monkeypatch) > 10 * TOL


def test_yarn_ramp_of_the_test_config():
    """The frequency ramp this file's YaRN group makes: extrapolated at
    dim 0, interpolated from dim 3 (factor 40), two dims between; the
    program's frequencies are the reference's."""
    inv = L.rope_freqs(16, 10000.0, "cpu", _cfg().yarn)
    extra = L.rope_freqs(16, 10000.0, "cpu")
    assert torch.equal(inv, REF.yarn_inv_freq(PUB, "cpu"))
    assert inv[0] == extra[0]
    assert torch.allclose(inv[3:], extra[3:] / 40)
    r = inv[1:3] / extra[1:3]
    assert ((r < 1) & (r > 1 / 40)).all()
    assert L.yarn_mscale(40, 0.707) ** 2 == pytest.approx(1.5896, abs=1e-4)
