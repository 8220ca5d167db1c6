"""Plain fp32 reference of Mamba-2 (arXiv:2405.21060, the ``Mamba2``
block of ``mamba_ssm``): token embedding; per layer RMSNorm, the input
projection to z, x, B, C and dt, a causal depthwise conv with bias and
SiLU over x, B and C, dt = softplus(dt + dt_bias), A = -exp(A_log), the
SSD scan y_t = C_t h_t with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
plus D x, the gated RMSNorm of y * silu(z) over the whole inner width
(``norm_before_gate=False``, one group), the output projection and the
residual; a final RMSNorm and the LM head tied to the embedding.  One
sequence at a time, no cache, no batching, no kernel.

The scan runs in chunks (the paper's minimal SSD listing): within a
chunk the quadratic form, across chunks the carried state; in exact
arithmetic this is the recurrence.  Departures from the published code,
none of which changes the function: the input projection is kept as five
matrices and the conv as three (it is depthwise); weights are stored
``x @ w``; every RMSNorm gain is stored as the gain less one
(``common.rms_norm``); the residual is fp32 throughout, as
``residual_in_fp32`` asks.  The weights are the harness's, drawn by
``draw`` and named as the served module names its parameters.

Imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import (Precision, causal_conv, draw_normal,
                                        rms_norm)

EMBED_STD = 0.02
GAIN_STD = 0.1
CONV_BIAS_STD = 0.1


def dims(pub: dict) -> dict:
    """The block's sizes from the published config and the block's
    defaults (which ``assumed`` of the configuration file records)."""
    d = pub["d_model"]
    d_in = pub["expand"] * d
    mult = pub["pad_vocab_size_multiple"]
    vocab = -(-pub["vocab_size"] // mult) * mult
    return dict(d=d, d_in=d_in, H=d_in // pub["headdim"], P=pub["headdim"],
                G=pub["ngroups"], N=pub["d_state"], W=pub["d_conv"],
                Q=pub["chunk_size"], V=vocab, layers=pub["n_layer"],
                eps=pub["norm_epsilon"])


def port_fields(pub: dict) -> dict:
    """The served model's configuration fields, read off the published
    config."""
    m = dims(pub)
    return dict(
        num_layers=m["layers"], d_model=m["d"], vocab_size=m["V"],
        norm_eps=m["eps"], tie_embeddings=bool(pub["tie_embeddings"]),
        ssm=dict(state_dim=m["N"], conv_dim=m["W"], expand=pub["expand"],
                 head_dim=m["P"], n_groups=m["G"], chunk_size=m["Q"]))


def weight_specs(pub: dict) -> list:
    """[(name, shape, std)] of the normally drawn weights, in draw
    order."""
    m = dims(pub)
    d, d_in, GN, W = m["d"], m["d_in"], m["G"] * m["N"], m["W"]
    specs = [("embed", (m["V"], d), EMBED_STD)]
    for i in range(m["layers"]):
        p = f"layers.{i}."
        specs += [
            (p + "norm1", (d,), GAIN_STD),
            (p + "mixer.w_z", (d, d_in), d ** -0.5),
            (p + "mixer.w_x", (d, d_in), d ** -0.5),
            (p + "mixer.w_B", (d, GN), d ** -0.5),
            (p + "mixer.w_C", (d, GN), d ** -0.5),
            (p + "mixer.w_dt", (d, m["H"]), d ** -0.5),
        ]
        for name, ch in (("x", d_in), ("B", GN), ("C", GN)):
            specs += [(p + f"mixer.conv_{name}_w", (W, ch), W ** -0.5),
                      (p + f"mixer.conv_{name}_b", (ch,), CONV_BIAS_STD)]
        specs += [(p + "mixer.gate_norm", (d_in,), GAIN_STD),
                  (p + "mixer.out_proj", (d_in, d), d_in ** -0.5)]
    specs.append(("final_norm", (d,), GAIN_STD))
    return specs


def draw(pub: dict, seed: int, device) -> dict:
    """Every weight from ``seed``, fp32, on ``device``: the normal ones in
    one flat buffer, then per layer A, dt and D as ``mamba_ssm``
    initialises them (A ~ U(1, 16); dt log-uniform on [1e-3, 1e-1], kept
    as its softplus inverse; D near 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    W = draw_normal(weight_specs(pub), gen, device)
    m = dims(pub)
    n, H = m["layers"], m["H"]
    u = torch.rand((3, n, H), generator=gen, device=device)
    A = 1.0 + 15.0 * u[0]
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    D = 1.0 + 0.2 * (u[2] - 0.5)
    for i in range(n):
        p = f"layers.{i}.mixer."
        W[p + "A_log"] = torch.log(A[i])
        W[p + "dt_bias"] = dt_bias[i]
        W[p + "D"] = D[i]
    return W


def ssd_scan(x, dt, A, B, C, Q: int) -> torch.Tensor:
    """fp32 SSD: x (L, H, P), dt (L, H), A (H,) negative, B/C (L, H, N)
    -> y (L, H, P), from a zero state, in chunks of Q."""
    L, H, P = x.shape
    N = B.shape[-1]
    state = x.new_zeros((H, P, N))
    ys = []
    for c0 in range(0, L, Q):
        xc, dtc, Bc, Cc = (t[c0:c0 + Q] for t in (x, dt, B, C))
        q = xc.shape[0]
        cs = torch.cumsum(dtc * A, dim=0)                     # (q, H)
        keep = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                     device=x.device))
        seg = (cs[:, None, :] - cs[None, :, :]).masked_fill(
            ~keep[..., None], float("-inf"))
        w = torch.einsum("ihn,jhn->ijh", Cc, Bc) * torch.exp(seg)
        y = torch.einsum("ijh,jh,jhp->ihp", w, dtc, xc)
        y = y + torch.einsum("ihn,hpn->ihp", Cc, state) \
            * torch.exp(cs)[..., None]
        decay = torch.exp(cs[-1][None, :] - cs)               # (q, H)
        state = state * torch.exp(cs[-1])[:, None, None] + torch.einsum(
            "jhn,jh,jhp->hpn", Bc, decay * dtc, xc)
        ys.append(y)
    return torch.cat(ys)


@torch.no_grad()
def logits(W: dict, pub: dict, tokens: torch.Tensor, first: int,
           precision: Precision) -> torch.Tensor:
    """fp32 logits (L - first, V) at positions ``first``..L-1 of the
    sequence ``tokens`` (L,)."""
    m = dims(pub)
    L, H, P, G, N = tokens.shape[0], m["H"], m["P"], m["G"], m["N"]
    eps, mm = m["eps"], precision.mm
    x = W["embed"][tokens.long()].float()
    for i in range(m["layers"]):
        p = f"layers.{i}.mixer."
        h = rms_norm(x, W[f"layers.{i}.norm1"], eps)
        z = mm(h, W[p + "w_z"])
        u = {name: F.silu(causal_conv(mm(h, W[p + f"w_{name}"]),
                                      W[p + f"conv_{name}_w"],
                                      W[p + f"conv_{name}_b"]))
             for name in ("x", "B", "C")}
        dt = F.softplus(mm(h, W[p + "w_dt"]) + W[p + "dt_bias"].float())
        xs = u["x"].view(L, H, P)
        Bm, Cm = (u[n].view(L, G, N).repeat_interleave(H // G, dim=1)
                  for n in ("B", "C"))
        y = ssd_scan(xs, dt, -torch.exp(W[p + "A_log"].float()), Bm, Cm,
                     m["Q"])
        y = (y + xs * W[p + "D"].float()[None, :, None]).reshape(L, -1)
        y = rms_norm(y * F.silu(z), W[p + "gate_norm"], eps)
        x = x + mm(y, W[p + "out_proj"])
    x = rms_norm(x[first:], W["final_norm"], eps)
    return mm(x, W["embed"].T)
