"""Plain fp32 reference of DeepSeek-V2's decoder (``DeepseekV2ForCausalLM``
as published for DeepSeek-V2-Lite): token embedding; per layer RMSNorm,
multi-head latent attention in its expanded form (the query projection;
``kv_a`` to the latent and the shared rotary key; RMSNorm of the latent;
``kv_b`` to each head's no-rope key and value; YaRN rotary embedding on
the rope dims of the query and the key; causal softmax at the published
scale, 1/sqrt(qk_nope + qk_rope) times YaRN's mscale(factor,
mscale_all_dim)^2), the output projection and the residual; RMSNorm, then
a SwiGLU MLP on the first ``first_k_dense_replace`` layers and the MoE on
the others (an fp32 softmax router, greedy top-k, the weights left
unnormalised unless ``norm_topk_prob``, each expert's tokens computed in
a plain loop with no capacity, the shared experts added), and the
residual; a final RMSNorm and the untied LM head.  One sequence at a
time, no cache, no batching, no kernel; attention in blocks of queries
so that a long request fits beside the weights.

Departures from the published code, none of which changes the function:
weights are stored ``x @ w`` (in, out), ``kv_b`` as its key half
``w_uk`` and its value half ``w_uv``, ``kv_a`` as ``w_dkv``; every RMSNorm
gain is stored as the gain less one (``common.rms_norm``); the rotary
pairs are rotate-half (dim i with i + 32) where the published code
pairs adjacent dims: the same function up to a fixed permutation of the
64 rope columns of ``wq`` and ``w_dkv``, which random weights do not
see.  The router's product stays fp32 in the control too: the published
gate computes in fp32 whatever the model's precision.  The weights are
the harness's, drawn by ``draw`` (bf16, the router fp32, as the served
module holds them) and named as the served module names its parameters,
so the same tensors serve both sides.

Imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import PIECE, Precision, rms_norm

EMBED_STD = 0.02
GAIN_STD = 0.1        # norm gains drawn around the published init of 1


def _check(pub: dict) -> None:
    """The published settings this reference (and the program) compute."""
    want = {"scoring_func": "softmax", "topk_method": "greedy",
            "routed_scaling_factor": 1, "n_group": 1, "topk_group": 1,
            "q_lora_rank": None, "attention_bias": False,
            "hidden_act": "silu", "moe_layer_freq": 1}
    bad = {k: pub.get(k) for k, v in want.items() if pub.get(k) != v}
    rs = pub.get("rope_scaling")
    if rs is not None and rs.get("type") != "yarn":
        bad["rope_scaling.type"] = rs.get("type")
    if bad:
        raise ValueError(f"mla_moe computes none of {bad}")


def port_fields(pub: dict) -> dict:
    """The served model's configuration fields, read off the published
    config.  The MoE group names the dropless ``grouped`` dispatch: the
    published model computes every token's experts (no capacity)."""
    _check(pub)
    rs = pub["rope_scaling"]
    return dict(
        num_layers=pub["num_hidden_layers"], d_model=pub["hidden_size"],
        num_heads=pub["num_attention_heads"],
        num_kv_heads=pub["num_key_value_heads"],
        d_ff=pub["intermediate_size"], vocab_size=pub["vocab_size"],
        rope_theta=float(pub["rope_theta"]), norm_eps=pub["rms_norm_eps"],
        tie_embeddings=bool(pub["tie_word_embeddings"]), mlp_act="silu",
        mla=dict(kv_lora_rank=pub["kv_lora_rank"], q_lora_rank=0,
                 qk_nope_head_dim=pub["qk_nope_head_dim"],
                 qk_rope_head_dim=pub["qk_rope_head_dim"],
                 v_head_dim=pub["v_head_dim"]),
        moe=dict(num_experts=pub["n_routed_experts"],
                 top_k=pub["num_experts_per_tok"],
                 num_shared_experts=pub["n_shared_experts"],
                 expert_d_ff=pub["moe_intermediate_size"], layer_period=1,
                 first_dense_layers=pub["first_k_dense_replace"],
                 norm_topk_prob=bool(pub["norm_topk_prob"]),
                 serve_impl="grouped"),
        yarn=dict(factor=float(rs["factor"]),
                  original_max_position=int(
                      rs["original_max_position_embeddings"]),
                  beta_fast=float(rs["beta_fast"]),
                  beta_slow=float(rs["beta_slow"]),
                  mscale=float(rs["mscale"]),
                  mscale_all_dim=float(rs["mscale_all_dim"])))


def weight_specs(pub: dict) -> list:
    """[(name, shape, std, dtype)] of every weight, in draw order."""
    bf, f32 = torch.bfloat16, torch.float32
    d, V, H = pub["hidden_size"], pub["vocab_size"], \
        pub["num_attention_heads"]
    nope, rope, vd, r = (pub["qk_nope_head_dim"], pub["qk_rope_head_dim"],
                         pub["v_head_dim"], pub["kv_lora_rank"])
    E, f = pub["n_routed_experts"], pub["moe_intermediate_size"]
    fs = pub["n_shared_experts"] * f
    F = pub["intermediate_size"]
    specs = [("embed", (V, d), EMBED_STD, bf)]
    for i in range(pub["num_hidden_layers"]):
        p = f"layers.{i}."
        specs += [
            (p + "norm1", (d,), GAIN_STD, bf),
            (p + "mixer.wq", (d, H * (nope + rope)), d ** -0.5, bf),
            (p + "mixer.w_dkv", (d, r + rope), d ** -0.5, bf),
            (p + "mixer.kv_norm", (r,), GAIN_STD, bf),
            (p + "mixer.w_uk", (r, H * nope), r ** -0.5, bf),
            (p + "mixer.w_uv", (r, H * vd), r ** -0.5, bf),
            (p + "mixer.wo", (H * vd, d), (H * vd) ** -0.5, bf),
            (p + "norm2", (d,), GAIN_STD, bf),
        ]
        if i < pub["first_k_dense_replace"]:
            specs += [(p + "mlp.w_gate", (d, F), d ** -0.5, bf),
                      (p + "mlp.w_up", (d, F), d ** -0.5, bf),
                      (p + "mlp.w_down", (F, d), F ** -0.5, bf)]
        else:
            specs += [(p + "moe.router", (d, E), d ** -0.5, f32),
                      (p + "moe.w_gate", (E, d, f), d ** -0.5, bf),
                      (p + "moe.w_up", (E, d, f), d ** -0.5, bf),
                      (p + "moe.w_down", (E, f, d), f ** -0.5, bf),
                      (p + "moe.shared.w_gate", (d, fs), d ** -0.5, bf),
                      (p + "moe.shared.w_up", (d, fs), d ** -0.5, bf),
                      (p + "moe.shared.w_down", (fs, d), fs ** -0.5, bf)]
    specs.append(("final_norm", (d,), GAIN_STD, bf))
    if not pub["tie_word_embeddings"]:
        specs.append(("lm_head", (d, V), d ** -0.5, bf))
    return specs


def draw(pub: dict, seed: int, device) -> dict:
    """Every weight from ``seed`` on ``device``: N(0, std^2) drawn in fp32
    pieces of at most ``PIECE`` elements and stored in the weight's dtype
    (one flat buffer a dtype; each weight a contiguous view of it)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    specs = weight_specs(pub)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    bufs, at = {}, {}
    for dt in {dt for *_, dt in specs}:
        n = sum(s for s, sp in zip(sizes, specs) if sp[3] == dt)
        bufs[dt] = torch.empty(n, dtype=dt, device=device)
        at[dt] = 0
    out = {}
    for (name, shape, std, dt), n in zip(specs, sizes):
        flat = bufs[dt][at[dt]:at[dt] + n]
        at[dt] += n
        for lo in range(0, n, PIECE):
            hi = min(n, lo + PIECE)
            piece = torch.empty(hi - lo, dtype=torch.float32, device=device)
            flat[lo:hi].copy_(piece.normal_(generator=gen).mul_(std))
            del piece
        out[name] = flat.view(shape)
    return out


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(pub: dict, device) -> torch.Tensor:
    """(rope / 2,) inverse frequencies of ``DeepseekV2YarnRotaryEmbedding``:
    extrapolated below the beta_fast correction dim, interpolated (over
    ``factor``) above the beta_slow one, a linear ramp between."""
    dim, base = pub["qk_rope_head_dim"], float(pub["rope_theta"])
    rs = pub["rope_scaling"]
    i2 = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** i2
    if rs is None:
        return extra
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]
    inter = 1.0 / (factor * base ** i2)

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(pub: dict) -> float:
    s = (pub["qk_nope_head_dim"] + pub["qk_rope_head_dim"]) ** -0.5
    rs = pub["rope_scaling"]
    if rs is not None and rs.get("mscale_all_dim"):
        s *= _mscale(float(rs["factor"]), rs["mscale_all_dim"]) ** 2
    return s


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, scale: float, block: int = 512) -> torch.Tensor:
    """Causal attention in fp32: q/k (L, H, Dk), v (L, H, Dv) ->
    (L, H * Dv)."""
    L, H, _ = q.shape
    out = torch.empty((L, H, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    kpos = torch.arange(L, device=q.device)
    for s0 in range(0, L, block):
        qb = q[s0:s0 + block]
        hi = s0 + qb.shape[0]
        s = torch.einsum("shd,thd->hst", qb, k[:hi]) * scale
        qpos = torch.arange(s0, hi, device=q.device)
        s = s.masked_fill(kpos[None, None, :hi] > qpos[None, :, None],
                          float("-inf"))
        out[s0:hi] = torch.einsum("hst,thd->shd", torch.softmax(s, -1),
                                  v[:hi])
    return out.reshape(L, -1)


def _mlp(mm, h, wg, wu, wd):
    return mm(torch.nn.functional.silu(mm(h, wg)) * mm(h, wu), wd)


def moe(W: dict, p: str, pub: dict, h: torch.Tensor,
        mm) -> torch.Tensor:
    """The MoE feed-forward of the layer with prefix ``p``: h (L, d)."""
    k = pub["num_experts_per_tok"]
    probs = torch.softmax(h.float() @ W[p + "router"].float(), dim=-1)
    top, idx = torch.topk(probs, k, dim=-1)
    if pub["norm_topk_prob"]:
        top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    wg, wu, wd = W[p + "w_gate"], W[p + "w_up"], W[p + "w_down"]
    for e in range(pub["n_routed_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        ye = _mlp(mm, h[rows], wg[e], wu[e], wd[e])
        y.index_add_(0, rows, ye * top[rows, slot, None])
    return y + _mlp(mm, h, W[p + "shared.w_gate"], W[p + "shared.w_up"],
                    W[p + "shared.w_down"])


@torch.no_grad()
def logits(W: dict, pub: dict, tokens: torch.Tensor, first: int,
           precision: Precision) -> torch.Tensor:
    """fp32 logits (L - first, V) at positions ``first``..L-1 of the
    sequence ``tokens`` (L,), positions from 0."""
    _check(pub)
    L = tokens.shape[0]
    H = pub["num_attention_heads"]
    nope, rope, vd, r = (pub["qk_nope_head_dim"], pub["qk_rope_head_dim"],
                         pub["v_head_dim"], pub["kv_lora_rank"])
    eps = pub["rms_norm_eps"]
    mm = precision.mm
    x = W["embed"][tokens.long()].float()
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * yarn_inv_freq(pub, x.device)[None, :]
    rs = pub["rope_scaling"]
    ms = 1.0 if rs is None else (
        _mscale(float(rs["factor"]), rs["mscale"])
        / _mscale(float(rs["factor"]), rs["mscale_all_dim"]))
    cos, sin = (torch.cos(ang) * ms)[:, None, :], \
        (torch.sin(ang) * ms)[:, None, :]
    scale = softmax_scale(pub)
    for i in range(pub["num_hidden_layers"]):
        p = f"layers.{i}."
        h = rms_norm(x, W[p + "norm1"], eps)
        q = mm(h, W[p + "mixer.wq"]).view(L, H, nope + rope)
        ckr = mm(h, W[p + "mixer.w_dkv"])
        ckv = rms_norm(ckr[:, :r], W[p + "mixer.kv_norm"], eps)
        k_pe = _rope(ckr[:, None, r:], cos, sin).expand(L, H, rope)
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], -1)
        k = torch.cat([mm(ckv, W[p + "mixer.w_uk"]).view(L, H, nope),
                       k_pe], -1)
        v = mm(ckv, W[p + "mixer.w_uv"]).view(L, H, vd)
        x = x + mm(_attend(q, k, v, scale), W[p + "mixer.wo"])
        h = rms_norm(x, W[p + "norm2"], eps)
        if i < pub["first_k_dense_replace"]:
            x = x + _mlp(mm, h, W[p + "mlp.w_gate"], W[p + "mlp.w_up"],
                         W[p + "mlp.w_down"])
        else:
            x = x + moe(W, p + "moe.", pub, h, mm)
    x = rms_norm(x[first:], W["final_norm"], eps)
    head = W["embed"].T if pub["tie_word_embeddings"] else W["lm_head"]
    return mm(x, head)
