"""Attention: GQA/MQA/MHA, prefill and decode paths, plus the KV cache.

Three implementations selected by ``cfg.attn_impl``:
  * ``chunked`` — flash-style loop over KV blocks in plain torch, online
    softmax in fp32, O(S·D) memory.
  * ``pallas``  — the hand-written CUDA kernels (``kernels/ops.py``):
    decode attention for the one-token decode, flash attention (forward
    and backward) for the cache-free forward; on a CPU tensor ``ops`` runs
    their plain versions.  Prefill against a cache and segment ids take
    ``chunked``, as in the JAX package.
  * ``naive``   — full S×T score matrix; the reference's decode path.

MLA and cross-attention are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, LOCAL_ATTN
from repro_torch.models import layers as L

NEG_INF = -1.0e30


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # scale rounded to q's dtype first, as the reference multiplies
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# core chunked flash-style attention (plain torch, loop over KV blocks)
# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, q_pos, k_pos, *, scale: float,
                      causal: bool = True, window: int = 0,
                      cap: float = 0.0, chunk: int = 512,
                      k_valid=None, seg_q=None, seg_k=None,
                      q_chunk: int = 4096) -> torch.Tensor:
    """Flash-style attention.  q: (B,S,Hq,Dk); k/v: (B,T,H,D*).

    Long sequences are processed in ``q_chunk`` query blocks.  For the
    causal self-attention layout (T == S, no cache) each query block only
    multiplies against its *reachable* KV prefix (and, for sliding-window
    layers, only the [lo, hi) KV band).  Within a block, KV chunks stream
    through an online-softmax accumulator.
    """
    B, S, Hq, Dk = q.shape
    T = k.shape[1]
    if S > q_chunk and S % q_chunk == 0 and q_pos.dim() == 2:
        outs = []
        for i in range(S // q_chunk):
            sl = slice(i * q_chunk, (i + 1) * q_chunk)
            qi, qpi = q[:, sl], q_pos[:, sl]
            sqi = seg_q[:, sl] if seg_q is not None else None
            if causal and k_valid is None and T == S:
                hi = (i + 1) * q_chunk
                lo = max(0, i * q_chunk - window + 1) if window else 0
                lo = (lo // chunk) * chunk          # chunk-aligned band
                ki, vi, kpi = k[:, lo:hi], v[:, lo:hi], k_pos[:, lo:hi]
                ski = seg_k[:, lo:hi] if seg_k is not None else None
            else:
                ki, vi, kpi, ski = k, v, k_pos, seg_k
            outs.append(_chunked_attention(
                qi, ki, vi, qpi, kpi, scale=scale, causal=causal,
                window=window, cap=cap, chunk=chunk, k_valid=k_valid,
                seg_q=sqi, seg_k=ski))
        return torch.cat(outs, dim=1)
    return _chunked_attention(q, k, v, q_pos, k_pos, scale=scale,
                              causal=causal, window=window, cap=cap,
                              chunk=chunk, k_valid=k_valid, seg_q=seg_q,
                              seg_k=seg_k)


def _chunked_attention(q, k, v, q_pos, k_pos, *, scale: float,
                       causal: bool = True, window: int = 0,
                       cap: float = 0.0, chunk: int = 512,
                       k_valid=None, seg_q=None, seg_k=None) -> torch.Tensor:
    """q: (B,S,Hq,Dk), k: (B,T,Hkv,Dk), v: (B,T,Hkv,Dv).

    q_pos: (B,S) absolute positions of queries; k_pos: (B,T) of keys.
    k_valid: (B,T) bool — entries that exist (cache fill mask).
    Returns (B,S,Hq,Dv).  All accumulation in fp32; products of the
    working dtype are exact in fp32, so upcasting the operands is the
    reference's fp32-accumulating product.
    """
    B, S, Hq, Dk = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    c = min(chunk, T)

    qf = _scaled(q, scale).float().reshape(B, S, Hkv, G, Dk)
    m = torch.full((B, S, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros((B, S, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Hkv, G, Dv), dtype=torch.float32,
                      device=q.device)
    for t0 in range(0, T, c):
        k_i, v_i = k[:, t0:t0 + c], v[:, t0:t0 + c]
        p_i = k_pos[:, t0:t0 + c]
        s = torch.einsum("bshgd,bchd->bshgc", qf, k_i.float())
        if cap:
            s = cap * torch.tanh(s / cap)
        mask = (torch.ones_like(p_i, dtype=torch.bool) if k_valid is None
                else k_valid[:, t0:t0 + c])[:, None, :]          # (B,1,c)
        if causal:
            mask = mask & (p_i[:, None, :] <= q_pos[:, :, None])
        if window:
            mask = mask & (q_pos[:, :, None] - p_i[:, None, :] < window)
        if seg_k is not None:
            mask = mask & (seg_k[:, t0:t0 + c][:, None, :]
                           == seg_q[:, :, None])
        mask = mask[:, :, None, None, :]                         # (B,S,1,1,c)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(v_i.dtype).float(), v_i.float())
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(B, S, Hq, Dv).to(q.dtype)


def naive_attention(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                    cap=0.0, k_valid=None, seg_q=None, seg_k=None):
    """Full-score attention (decode path + tiny-shape oracle).

    Probabilities are cast to v's dtype before the PV product, as the
    reference does (exact when v is fp32)."""
    B, S, Hq, Dk = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = _scaled(q, scale).float().reshape(B, S, Hkv, G, Dk)
    s = torch.einsum("bshgd,bthd->bshgt", qf, k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    mask = torch.ones((B, S, k.shape[1]), dtype=torch.bool, device=q.device)
    if k_valid is not None:
        mask = mask & k_valid[:, None, :]
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    if seg_q is not None:
        mask = mask & (seg_k[:, None, :] == seg_q[:, :, None])
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask[:, :, None, None, :]
    out = torch.einsum("bshgt,bthd->bshgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, Hq, -1).to(q.dtype)


def _run_attention(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, scale, causal,
                   window, cap, k_valid=None, seg_q=None, seg_k=None):
    if cfg.attn_impl == "pallas" and seg_q is None \
            and k.shape[-1] == v.shape[-1]:
        from repro_torch.kernels import ops as kops
        if q.shape[1] == 1:   # decode
            # The cache already holds this token's key at index q_pos, so
            # the fill that counts is q_pos + 1.  (The JAX package passes
            # q_pos here and so drops the token's own key.)  Inactive
            # slots carry q_pos == -1: fill 0, output 0.
            return kops.decode_attention(
                q, k, v, (q_pos[:, 0] + 1).to(torch.int32), scale=scale,
                window=window, cap=cap)
        if k_valid is None and q.shape[1] == k.shape[1]:
            # the cache-free forward (training, prefill from zero)
            return kops.flash_attention(q, k, v, scale=scale, causal=causal,
                                        window=window, cap=cap)
        # other combinations take the plain paths below, as in the JAX
        # package's dispatch
    if cfg.attn_impl == "naive" or q.shape[1] == 1:
        return naive_attention(q, k, v, q_pos, k_pos, scale=scale,
                               causal=causal, window=window, cap=cap,
                               k_valid=k_valid, seg_q=seg_q, seg_k=seg_k)
    return chunked_attention(q, k, v, q_pos, k_pos, scale=scale,
                             causal=causal, window=window, cap=cap,
                             chunk=cfg.attn_chunk, k_valid=k_valid,
                             seg_q=seg_q, seg_k=seg_k)


# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                  device) -> dict:
    """Zeroed cache dict for one attention layer."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    dt = L.dtype_of(cfg)
    size = (min(max_len, cfg.window_size)
            if (kind == LOCAL_ATTN and cfg.window_size) else max_len)
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
    }


def _ring_write(buf: torch.Tensor, new: torch.Tensor,
                offsets: torch.Tensor) -> None:
    """Write `new` (B, P, ...) into ring buffer `buf` (B, T, ...) in place,
    at positions (offsets + arange(P)) mod T, per batch row."""
    B, P = new.shape[:2]
    T = buf.shape[1]
    ar = torch.arange(P, device=buf.device)
    idx = (offsets.long()[:, None] + ar[None, :]) % T               # (B,P)
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, P)
    buf.index_put_((bidx, idx), new.to(buf.dtype))


def update_cache(cache: dict, new: dict, offsets: torch.Tensor,
                 positions: torch.Tensor) -> dict:
    """new: dict of (B,P,...) tensors; positions: (B,P) absolute positions.

    Unlike the JAX package's functional update, this writes the cache
    tensors in place (``index_put_``) and returns the same dict: serving
    owns its cache, and a copy per layer per step would double its
    traffic."""
    for name, val in new.items():
        _ring_write(cache[name], val, offsets)
    _ring_write(cache["pos"], positions.to(torch.int32), offsets)
    return cache


# ---------------------------------------------------------------------------
# standard GQA attention layer
# ---------------------------------------------------------------------------
def attention_layer(p, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, kind: str,
                    cache: Optional[dict] = None,
                    cache_offset: Optional[torch.Tensor] = None,
                    seg: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,d); ``p`` holds the layer's weights (``models.transformer
    .Attention``).  Train/prefill: cache None or appended-to.  Decode: S
    small (usually 1), cache required.  positions: (B,S)."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    dt = x.dtype
    B, S, _ = x.shape
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = L.rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.use_rope:
        angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = L.apply_rope(q, angles)
        k = L.apply_rope(k, angles)

    scale = cfg.attn_scale or (1.0 / math.sqrt(cfg.head_dim))
    window = cfg.window_size if kind == LOCAL_ATTN else 0

    if cache is None:
        out = _run_attention(cfg, q, k, v, positions, positions, scale=scale,
                             causal=causal, window=window,
                             cap=cfg.attn_softcap, seg_q=seg, seg_k=seg)
    else:
        cache = update_cache(cache, {"k": k, "v": v}, cache_offset, positions)
        k_valid = cache["pos"] >= 0
        out = _run_attention(cfg, q, cache["k"], cache["v"], positions,
                             cache["pos"], scale=scale, causal=causal,
                             window=window, cap=cfg.attn_softcap,
                             k_valid=k_valid)
    out = out.reshape(B, S, cfg.q_dim) @ p.wo.to(dt)
    return out, cache
