"""Plain fp32 reference of a dense decoder with grouped-query attention,
as Qwen3 publishes it (``Qwen3ForCausalLM``): token embedding; per layer
RMSNorm, q/k/v projections, a per-head RMSNorm of q and k, rotary
embedding (rotate-half, theta from the config), causal attention with
``num_attention_heads / num_key_value_heads`` query heads a key head, the
output projection and the residual; RMSNorm, a SwiGLU MLP and the
residual; a final RMSNorm and the LM head (untied unless the config ties
it).  One sequence at a time, no cache, no batching, no kernel.

Departures from the published code, none of which changes the function:
weights are stored ``x @ w`` (in, out); every RMSNorm gain is stored as
the gain less one (``common.rms_norm``).  The weights are the harness's,
drawn by ``draw`` and named as the served module names its parameters,
so the same tensors serve both sides.

Imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import Precision, draw_normal, rms_norm

EMBED_STD = 0.02
GAIN_STD = 0.1        # norm gains drawn around the published init of 1


def port_fields(pub: dict) -> dict:
    """The served model's configuration fields, read off the published
    config."""
    return dict(
        num_layers=pub["num_hidden_layers"], d_model=pub["hidden_size"],
        num_heads=pub["num_attention_heads"],
        num_kv_heads=pub["num_key_value_heads"], head_dim=pub["head_dim"],
        d_ff=pub["intermediate_size"], vocab_size=pub["vocab_size"],
        rope_theta=float(pub["rope_theta"]), norm_eps=pub["rms_norm_eps"],
        tie_embeddings=bool(pub["tie_word_embeddings"]), qk_norm=True,
        qkv_bias=bool(pub.get("attention_bias", False)),
        mlp_act={"silu": "silu"}[pub["hidden_act"]])


def weight_specs(pub: dict) -> list:
    """[(name, shape, std)] of every weight, in draw order."""
    d, V = pub["hidden_size"], pub["vocab_size"]
    H, Hkv, D = (pub["num_attention_heads"], pub["num_key_value_heads"],
                 pub["head_dim"])
    F = pub["intermediate_size"]
    specs = [("embed", (V, d), EMBED_STD)]
    for i in range(pub["num_hidden_layers"]):
        p = f"layers.{i}."
        specs += [
            (p + "norm1", (d,), GAIN_STD),
            (p + "mixer.wq", (d, H * D), d ** -0.5),
            (p + "mixer.wk", (d, Hkv * D), d ** -0.5),
            (p + "mixer.wv", (d, Hkv * D), d ** -0.5),
            (p + "mixer.wo", (H * D, d), (H * D) ** -0.5),
            (p + "mixer.q_norm", (D,), GAIN_STD),
            (p + "mixer.k_norm", (D,), GAIN_STD),
            (p + "norm2", (d,), GAIN_STD),
            (p + "mlp.w_gate", (d, F), d ** -0.5),
            (p + "mlp.w_up", (d, F), d ** -0.5),
            (p + "mlp.w_down", (F, d), F ** -0.5),
        ]
    specs.append(("final_norm", (d,), GAIN_STD))
    if not pub["tie_word_embeddings"]:
        specs.append(("lm_head", (d, V), d ** -0.5))
    return specs


def draw(pub: dict, seed: int, device) -> dict:
    """Every weight from ``seed``, fp32, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return draw_normal(weight_specs(pub), gen, device)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal GQA in fp32: q (L, H, D), k/v (L, Hkv, D) -> (L, H * D)."""
    L, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty((L, H, D), dtype=torch.float32, device=q.device)
    kpos = torch.arange(L, device=q.device)
    for s0 in range(0, L, block):
        qb = q[s0:s0 + block]
        hi = s0 + qb.shape[0]
        s = torch.einsum("shd,thd->hst", qb, k[:hi]) / math.sqrt(D)
        qpos = torch.arange(s0, hi, device=q.device)
        s = s.masked_fill(kpos[None, None, :hi] > qpos[None, :, None],
                          float("-inf"))
        out[s0:hi] = torch.einsum("hst,thd->shd", torch.softmax(s, -1),
                                  v[:hi])
    return out.reshape(L, H * D)


@torch.no_grad()
def logits(W: dict, pub: dict, tokens: torch.Tensor, first: int,
           precision: Precision) -> torch.Tensor:
    """fp32 logits (L - first, V) at positions ``first``..L-1 of the
    sequence ``tokens`` (L,), positions from 0."""
    L = tokens.shape[0]
    H, Hkv, D = (pub["num_attention_heads"], pub["num_key_value_heads"],
                 pub["head_dim"])
    eps = pub["rms_norm_eps"]
    mm = precision.mm
    x = W["embed"][tokens.long()].float()
    inv = float(pub["rope_theta"]) ** (
        -torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    for i in range(pub["num_hidden_layers"]):
        p = f"layers.{i}."
        h = rms_norm(x, W[p + "norm1"], eps)
        q = mm(h, W[p + "mixer.wq"]).view(L, H, D)
        k = mm(h, W[p + "mixer.wk"]).view(L, Hkv, D)
        v = mm(h, W[p + "mixer.wv"]).view(L, Hkv, D)
        q = _rope(rms_norm(q, W[p + "mixer.q_norm"], eps), cos, sin)
        k = _rope(rms_norm(k, W[p + "mixer.k_norm"], eps), cos, sin)
        x = x + mm(_attend(q, k, v), W[p + "mixer.wo"])
        h = rms_norm(x, W[p + "norm2"], eps)
        g = torch.nn.functional.silu(mm(h, W[p + "mlp.w_gate"])) \
            * mm(h, W[p + "mlp.w_up"])
        x = x + mm(g, W[p + "mlp.w_down"])
    x = rms_norm(x[first:], W["final_norm"], eps)
    head = W["embed"].T if pub["tie_word_embeddings"] else W["lm_head"]
    return mm(x, head)
