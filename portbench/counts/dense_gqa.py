"""Work a dense GQA decoder's traffic needs, counted from the published
config and the tokens served, not from what the program executes: no
padding rows, no weight casts, no logits nobody samples.

Every function takes the published config (``pub``) and numpy arrays of
one call of the serving step: ``lengths`` (B,) the tokens already in each
slot's cache, and ``valid_n`` (B,) the tokens a prefill row adds or
``active`` (B,) the rows a decode step advances.
"""
from __future__ import annotations

import numpy as np

ELEM = 2          # bytes of a bf16 activation or cache entry


def _dims(pub: dict):
    return (pub["hidden_size"], pub["num_attention_heads"],
            pub["num_key_value_heads"], pub["head_dim"],
            pub["intermediate_size"], pub["num_hidden_layers"],
            pub["vocab_size"])


def layer_weight_macs(pub: dict) -> int:
    """Multiply-adds of one layer's weight products for one token."""
    d, H, Hkv, D, F, _, _ = _dims(pub)
    return d * H * D + 2 * d * Hkv * D + H * D * d + 3 * d * F


def token_flops(pub: dict, ctx: np.ndarray) -> float:
    """FLOPs of tokens through every layer, each attending ``ctx``
    positions (itself included): the weight products and attention's
    QK and PV products."""
    _, H, _, D, _, n, _ = _dims(pub)
    ctx = np.asarray(ctx, dtype=np.float64)
    return float(n * (2 * layer_weight_macs(pub) * ctx.size
                      + 4 * H * D * ctx.sum()))


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


def decode_attention_work(pub: dict, lengths, active):
    """(flops, bytes) of one decode-attention launch (one layer of a
    decode call): for each active row, K and V up to its fill (length + 1:
    the cache holds the new token), its q and output, and its length;
    QK and PV products of every query head over those keys."""
    _, H, Hkv, D, _, _, _ = _dims(pub)
    act = np.asarray(active, bool)
    fill = (np.asarray(lengths)[act] + 1).astype(np.float64)
    kv_elems = fill.sum() * Hkv * D
    nbytes = 2 * kv_elems * ELEM + act.sum() * (2 * H * D * ELEM + 4)
    flops = 4.0 * (H // Hkv) * kv_elems
    return flops, float(nbytes)


def launches_per_call(pub: dict) -> int:
    """Decode-attention launches in one decode call: one a layer."""
    return pub["num_hidden_layers"]
