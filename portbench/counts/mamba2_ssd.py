"""Work a Mamba-2 model's traffic needs, counted from the published
config and the tokens served, not from what the program executes: no
padding rows, no weight casts, no logits nobody samples.

Arguments as in ``counts/dense_gqa.py``: numpy arrays of one call,
``lengths`` (B,), ``valid_n`` (B,) or ``active`` (B,).
"""
from __future__ import annotations

import numpy as np

from portbench.reference.mamba2_ssd import dims

ELEM = 2          # bytes of a bf16 activation


def layer_weight_macs(pub: dict) -> int:
    """Multiply-adds of one layer's weight products for one token."""
    m = dims(pub)
    GN = m["G"] * m["N"]
    return m["d"] * (2 * m["d_in"] + 2 * GN + m["H"]) + m["d_in"] * m["d"]


def conv_flops(pub: dict) -> int:
    """FLOPs of the depthwise convs for one token of one layer."""
    m = dims(pub)
    return 2 * m["W"] * (m["d_in"] + 2 * m["G"] * m["N"])


def scan_flops(pub: dict, n: int, state: bool = True) -> float:
    """FLOPs of the chunked SSD scan over n tokens of one row of one layer:
    per chunk of q rows the q(q+1)/2 scores over N and their products over
    P, the state update, and the carried state's term where a state comes
    in."""
    m = dims(pub)
    H, P, N, Q = m["H"], m["P"], m["N"], m["Q"]
    Q = min(Q, n)
    flops = 0
    for c0 in range(0, n, Q):
        q = min(Q, n - c0)
        flops += 2 * (q * (q + 1) // 2) * (N + P) + 2 * q * P * N
        if state or c0 > 0:
            flops += 2 * q * P * N
    return float(flops * H)


def head_flops(pub: dict) -> float:
    m = dims(pub)
    return 2.0 * m["d"] * m["V"]


def prefill_flops(pub: dict, lengths, valid_n, samples) -> float:
    """A prefill call: every valid token through every layer's products
    and convs, each row's chunk through the scan from its carried state;
    the head where a row's chunk ends its prompt (``samples``)."""
    m = dims(pub)
    tok = float(np.sum(valid_n))
    per_layer = tok * (2 * layer_weight_macs(pub) + conv_flops(pub)) + sum(
        scan_flops(pub, int(n)) for n in valid_n if n > 0)
    return m["layers"] * per_layer + head_flops(pub) * int(np.sum(samples))


def decode_flops(pub: dict, lengths, active) -> float:
    """A decode call: each active row's token through every layer, the
    recurrent update and readout (4 H P N), and sampled."""
    m = dims(pub)
    n = int(np.sum(np.asarray(active, bool)))
    per_tok = (2 * layer_weight_macs(pub) + conv_flops(pub)
               + 4 * m["H"] * m["P"] * m["N"])
    return float(n * m["layers"] * per_tok) + head_flops(pub) * n


def ssd_scan_work(pub: dict, lengths, valid_n):
    """(flops, bytes) of one SSD-scan launch (one layer of a prefill
    call) over the valid rows only: x and y (bf16), dt (fp32), B and C
    (bf16) of each valid token, each row's state in and out (fp32), and
    A_log once."""
    m = dims(pub)
    H, P, G, N = m["H"], m["P"], m["G"], m["N"]
    flops, nbytes = 0.0, H * 4.0
    for n in valid_n:
        if n <= 0:
            continue
        n = int(n)
        nbytes += (2 * n * H * P * ELEM + n * H * 4 + 2 * n * G * N * ELEM
                   + 2 * H * P * N * 4)
        flops += scan_flops(pub, n)
    return flops, nbytes


def launches_per_call(pub: dict) -> int:
    """SSD-scan launches in one prefill call: one a layer."""
    return dims(pub)["layers"]
