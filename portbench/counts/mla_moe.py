"""Work a DeepSeek-V2 decoder's traffic needs (MLA and a routed MoE),
counted from the published config and the tokens served, not from what
the program executes: no padding rows, no casts, no logits nobody
samples, attention in its expanded form (the published dims).

Every function takes the published config (``pub``) and numpy arrays of
one call of the serving step: ``lengths`` (B,) the tokens already in each
slot's cache, and ``valid_n`` (B,) the tokens a prefill row adds or
``active`` (B,) the rows a decode step advances.
"""
from __future__ import annotations

import numpy as np

ELEM = 2          # bytes of a bf16 weight or activation


def _moe_layers(pub: dict) -> int:
    return pub["num_hidden_layers"] - pub["first_k_dense_replace"]


def attention_weight_macs(pub: dict) -> int:
    """Multiply-adds of one layer's attention projections for one token:
    the query, ``kv_a`` (latent and rotary key), ``kv_b`` (each head's
    no-rope key and value) and the output."""
    d, H = pub["hidden_size"], pub["num_attention_heads"]
    nope, rope, vd, r = (pub["qk_nope_head_dim"], pub["qk_rope_head_dim"],
                         pub["v_head_dim"], pub["kv_lora_rank"])
    return (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd)
            + H * vd * d)


def ffn_macs(pub: dict, dense: bool) -> int:
    """Multiply-adds of one layer's feed-forward for one token: the dense
    SwiGLU, or the router, its top-k experts and the shared experts."""
    d, f = pub["hidden_size"], pub["moe_intermediate_size"]
    if dense:
        return 3 * d * pub["intermediate_size"]
    return (d * pub["n_routed_experts"]
            + 3 * d * f * (pub["num_experts_per_tok"]
                           + pub["n_shared_experts"]))


def token_flops(pub: dict, ctx: np.ndarray) -> float:
    """FLOPs of tokens through every layer, each attending ``ctx``
    positions (itself included): the weight products and attention's
    QK (nope + rope dims) and PV products of every head."""
    H, n = pub["num_attention_heads"], pub["num_hidden_layers"]
    dk = pub["qk_nope_head_dim"] + pub["qk_rope_head_dim"]
    ctx = np.asarray(ctx, dtype=np.float64)
    dense = pub["first_k_dense_replace"]
    macs = (n * attention_weight_macs(pub) + dense * ffn_macs(pub, True)
            + (n - dense) * ffn_macs(pub, False))
    return float(2 * macs * ctx.size
                 + n * 2 * H * (dk + pub["v_head_dim"]) * ctx.sum())


def head_flops(pub: dict) -> float:
    """FLOPs of the LM head for one sampled token."""
    return 2.0 * pub["hidden_size"] * pub["vocab_size"]


def prefill_flops(pub: dict, lengths, valid_n, samples) -> float:
    """A prefill call: each valid token at position p attends p + 1
    positions; the head runs where a row's chunk ends its prompt
    (``samples``)."""
    ctx = np.concatenate([np.arange(l, l + n) + 1
                          for l, n in zip(lengths, valid_n) if n > 0]
                         or [np.zeros(0)])
    return token_flops(pub, ctx) + head_flops(pub) * int(np.sum(samples))


def decode_flops(pub: dict, lengths, active) -> float:
    """A decode call: each active row's token at position ``length``
    attends length + 1 positions and is sampled."""
    act = np.asarray(active, bool)
    ctx = np.asarray(lengths)[act] + 1
    return token_flops(pub, ctx) + head_flops(pub) * int(act.sum())


def experts_hit(pub: dict, n: int) -> float:
    """Expected experts with at least one of ``n`` tokens in one layer,
    under balanced routing (each token's k distinct experts uniform):
    E (1 - (1 - k / E)^n)."""
    E, k = pub["n_routed_experts"], pub["num_experts_per_tok"]
    return E * (1.0 - (1.0 - k / E) ** n)


def moe_experts_work(pub: dict, lengths, rows):
    """(flops, bytes) of one call's routed-expert products, summed over
    its MoE layers, for the call's valid tokens (``rows``: ``valid_n`` of
    a prefill call, ``active`` of a decode call): 2 x 3 x d x f flops
    per (token, choice); the weights of the experts those tokens reach
    (``experts_hit``, the balanced-routing count, each read once) and the
    tokens' rows into and out of the products.  ``lengths`` is unused:
    the experts do not read the cache."""
    n = int(np.sum(rows))
    d, f, k = (pub["hidden_size"], pub["moe_intermediate_size"],
               pub["num_experts_per_tok"])
    flops = 2.0 * 3 * d * f * n * k
    nbytes = (experts_hit(pub, n) * 3 * d * f + 2 * n * k * d) * ELEM
    L = _moe_layers(pub)
    return L * flops, L * float(nbytes)
