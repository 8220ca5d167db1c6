"""Attention: GQA/MQA/MHA + DeepSeek MLA, prefill and decode paths, plus
the KV cache.

Three implementations selected by ``cfg.attn_impl``:
  * ``chunked`` — flash-style loop over KV blocks in plain torch, online
    softmax in fp32, O(S·D) memory.
  * ``pallas``  — the hand-written CUDA kernels (``kernels/ops.py``):
    decode attention for the one-token decode, flash attention (forward
    and backward) for the cache-free forward; on a CPU tensor ``ops`` runs
    their plain versions.  Prefill against a cache and segment ids take
    ``chunked``, as in the JAX package.
  * ``naive``   — full S×T score matrix; the reference's decode path.

MLA's absorbed path attends with K dim rank + rope != V dim rank, which
no kernel takes: it runs the plain paths under every implementation, as
in the JAX package.  Whisper's decoder cross-attention
(``cross_attention_layer``) attends every encoder frame, non-causal.

Under a serving layout (``distributed/parallel.py``) the layer computes
on this rank's shards.  When the cache's kv heads go over ``model``, q,
k and v come from the column slices of ``wq``/``wk``/``wv`` (whole
heads), attention runs on the local heads and ``wo`` is row-parallel,
summed by one all-reduce.  When the cache's length goes over an axis
instead, q, k and v are gathered whole, the new entries are written by
the rank whose slice holds their index, each rank attends its slice of
the positions, returning its log-sum-exp beside its output, and the
ranks' results merge by log-sum-exp before this rank's heads go through
``wo``.  The cache-free encoder gathers q, k and v whole where the heads
do not divide.  MLA computes its query heads, ``w_uk`` and ``w_uv`` on
this rank's heads (``w_dkv`` and ``kv_norm`` whole); its latent cache's
length goes over ``model``, so the absorbed decode gathers the latent
queries of every head, attends this rank's slice and merges by
log-sum-exp before this rank's heads go through ``w_uv`` and ``wo``.
The cross-attention reads its K/V where the cache holds them: this
rank's heads, or every head over this rank's frames (merged by
log-sum-exp), or every head whole.

A sharded train step over ``model`` (``distributed/parallel.py``)
computes on the same slices: q, k and v from the column slices of
``wq``/``wk``/``wv`` (whole query heads), the flash kernel on the local
heads, ``wo`` row-parallel.  Where the kv heads do not divide over
``model`` (8 on 16), each rank gathers the k/v columns over ``model`` and
keeps the kv heads of its query heads; the gather's gradient sums over the
ranks that share a head.  MLA's expanded path and the cross-attention
compute on the local heads too (MLA's whole ``w_dkv`` / ``kv_norm`` then
compute a part of the work, so their gradients sum over ``model``).
Attention whose query heads do not divide computes on whole weights
(under ``seq``, on the whole sequence).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.distributed import parallel as PAR
from repro_torch.models import layers as L

NEG_INF = -1.0e30


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # scale rounded to q's dtype first, as the reference multiplies; held
    # on the host as a 0-dim tensor, which a card's kernel takes by value
    # (a device copy of it would wait for the card, once a layer)
    return q * torch.tensor(scale, dtype=q.dtype)


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
                       k_valid=None, seg_q=None, seg_k=None,
                       return_lse: bool = False):
    """q: (B,S,Hq,Dk), k: (B,T,Hkv,Dk), v: (B,T,Hkv,Dv).

    q_pos: (B,S) absolute positions of queries; k_pos: (B,T) of keys.
    k_valid: (B,T) bool — entries that exist (cache fill mask).
    Returns (B,S,Hq,Dv), and with ``return_lse`` the log-sum-exp of each
    query's kept scores (B,S,Hq) fp32 beside it (NEG_INF where none is
    kept).  All accumulation in fp32; products of the working dtype are
    exact in fp32, so upcasting the operands is the reference's
    fp32-accumulating product.
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
    out = out.reshape(B, S, Hq, Dv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(lsum > 0, m + torch.log(torch.clamp(lsum, min=1e-30)),
                      NEG_INF)
    return out, lse.reshape(B, S, Hq)


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
            # slots carry q_pos == -1: fill 0, output 0.  A windowed
            # layer's cache is a ring (index = position mod T), so the
            # kernel masks by the stored positions, as ``naive_attention``
            # does, instead of by index.
            return kops.decode_attention(
                q, k, v, (q_pos[:, 0] + 1).to(torch.int32), scale=scale,
                window=window, cap=cap,
                positions=k_pos if window else None)
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
def cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """A layer's cache length: the window for a local layer (a ring)."""
    return (min(max_len, cfg.window_size)
            if (kind == LOCAL_ATTN and cfg.window_size) else max_len)


def init_kv_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                  device) -> dict:
    """Zeroed cache dict for one attention layer: k/v/pos, or for MLA the
    latent ``ckv``, the shared rotary key ``krope`` and pos."""
    dt = L.dtype_of(cfg)
    size = cache_len(cfg, kind, max_len)
    pos = torch.full((batch, size), -1, dtype=torch.int32, device=device)
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "ckv": torch.zeros((batch, size, m.kv_lora_rank), dtype=dt,
                               device=device),
            "krope": torch.zeros((batch, size, m.qk_rope_head_dim),
                                 dtype=dt, device=device),
            "pos": pos,
        }
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": pos,
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


def _ring_write_slice(buf: torch.Tensor, new: torch.Tensor,
                      offsets: torch.Tensor, lo: int, T: int) -> None:
    """``_ring_write`` into a ring of T entries of which ``buf`` (B, Tl,
    ...) holds indices [lo, lo + Tl): the entries whose index falls there
    are written, the rest are another rank's.  No host sync: one token
    (decode) writes its slot or rewrites the old value; a chunk gathers,
    for each held slot, the entry whose index it is."""
    B, P = new.shape[:2]
    Tl = buf.shape[1]
    rows = torch.arange(B, device=buf.device)
    tail = (1,) * (new.dim() - 2)
    if P == 1:
        idx = offsets.long() % T - lo
        li = idx.clamp(0, Tl - 1)
        mine = ((idx >= 0) & (idx < Tl)).reshape((B,) + tail)
        buf[rows, li] = torch.where(mine, new[:, 0].to(buf.dtype),
                                    buf[rows, li])
        return
    slots = torch.arange(Tl, device=buf.device) + lo
    j = (slots[None, :] - offsets.long()[:, None]) % T          # (B, Tl)
    hit = (j < P).reshape(j.shape + tail)
    src = new[rows[:, None], j.clamp(max=P - 1)].to(buf.dtype)
    buf.copy_(torch.where(hit, src, buf))


def _write_sharded(srv, cache: dict, new: dict, offsets, positions, T: int,
                   len_axis, pos_axis) -> torch.Tensor:
    """``update_cache`` on this rank's slices of a ring of T entries
    (k/v's length over ``len_axis``, pos's over ``pos_axis``, or whole);
    returns the positions that mask this rank's keys: its slice, or the
    whole row gathered when only ``pos`` is sliced (heads over
    ``model``)."""
    def write(buf, val, axis):
        if axis is None:
            _ring_write(buf, val, offsets)
        else:
            _ring_write_slice(buf, val, offsets,
                              srv.coord[axis] * buf.shape[1], T)
    for name, val in new.items():
        write(cache[name], val, len_axis)
    write(cache["pos"], positions.to(torch.int32), pos_axis)
    if pos_axis is not None and len_axis is None:
        return srv.all_gather(cache["pos"], (pos_axis,), dim=1)
    return cache["pos"]


def _length_sharded(cfg: ModelConfig, srv, axis: str, q, k, v, kpos,
                    pos2d, *, scale: float, window: int, cap: float
                    ) -> torch.Tensor:
    """Attention of whole q (B,S,Hq,Dk) over this rank's slice k (B,Tl,
    Hkv,Dk) / v (B,Tl,Hkv,Dv), stored positions kpos (B,Tl), of a cache
    whose length goes over mesh axis ``axis`` (the decode kernel with its
    log-sum-exp under ``pallas`` where Dk == Dv, the chunked path
    otherwise), merged with the other ranks' by log-sum-exp."""
    if cfg.attn_impl == "pallas" and q.shape[1] == 1 \
            and k.shape[-1] == v.shape[-1]:
        from repro_torch.kernels import ops as kops
        # a slice holds arbitrary indices: mask by the stored positions,
        # with the global fill q_pos + 1
        o, lse = kops.decode_attention(
            q, k, v, (pos2d[:, 0] + 1).to(torch.int32), scale=scale,
            window=window, cap=cap, positions=kpos, return_lse=True)
        lse = lse[:, None]
    else:
        o, lse = _chunked_attention(
            q, k, v, pos2d, kpos, scale=scale, causal=True, window=window,
            cap=cap, chunk=cfg.attn_chunk, k_valid=kpos >= 0,
            return_lse=True)
    return srv.merge_lse(o, lse, axis)


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
    small (usually 1), cache required.  positions: (B,S) or (3,B,S) for
    M-RoPE."""
    if cfg.mla is not None:
        return _mla_layer(p, x, positions, cfg, cache, cache_offset)
    # wo row-parallel: this rank's query heads (a serving or training
    # rank's shard)
    split = p.wo.shape[0] < cfg.q_dim
    x = PAR.block_in(x, split)
    dt = x.dtype
    B, S, _ = x.shape
    hd = cfg.head_dim
    pos2d = positions if positions.dim() == 2 else positions[0]
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    srv = PAR.serving()
    len_axis = pos_axis = None
    if srv is not None and cache is not None:
        T = cache_len(cfg, kind, srv.max_len)
        spec = srv.cache_spec("k", (srv.batch, T, cfg.num_kv_heads, hd))
        len_axis = spec[1]
        # ``pos`` has no head dim: the rule puts its length over ``model``
        # when the kv heads take that axis of k and v
        pos_axis = srv.cache_spec("pos", (srv.batch, T))[1]
        whole = spec[2] is None     # the cache holds every head
    else:
        # cache-free (the encoder): heads that do not divide compute whole
        whole = srv is not None and bool(
            cfg.num_heads % srv.model or cfg.num_kv_heads % srv.model)
    if whole:
        q = srv.gather_cols(q, cfg.q_dim)
        k = srv.gather_cols(k, cfg.kv_dim)
        v = srv.gather_cols(v, cfg.kv_dim)
    # the head counts are the local shapes' (a serving rank's heads)
    q = q.reshape(B, S, -1, hd)
    if split and srv is None:          # a training rank's heads
        k, v = _local_kv(p, k, v, cfg, q.shape[2])
        if cfg.qk_norm:
            PAR.mark_partial(p.q_norm, p.k_norm)
    else:
        k = k.reshape(B, S, -1, hd)
        v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = L.rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.use_rope:
        angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                               cfg.mrope_sections, cfg.yarn)
        ms = L.rope_mscale(cfg.yarn)
        q = L.apply_rope(q, angles, ms)
        k = L.apply_rope(k, angles, ms)

    scale = cfg.attn_scale or (1.0 / math.sqrt(cfg.head_dim))
    window = cfg.window_size if kind == LOCAL_ATTN else 0

    if cache is None:
        out = _run_attention(cfg, q, k, v, pos2d, pos2d, scale=scale,
                             causal=causal, window=window,
                             cap=cfg.attn_softcap, seg_q=seg, seg_k=seg)
    else:
        if srv is None:
            cache = update_cache(cache, {"k": k, "v": v}, cache_offset,
                                 pos2d)
            kpos = cache["pos"]
        else:
            kpos = _write_sharded(srv, cache, {"k": k, "v": v},
                                  cache_offset, pos2d, T, len_axis,
                                  pos_axis)
        if len_axis is not None:
            out = _length_sharded(cfg, srv, len_axis, q, cache["k"],
                                  cache["v"], kpos, pos2d, scale=scale,
                                  window=window, cap=cfg.attn_softcap)
        else:
            out = _run_attention(cfg, q, cache["k"], cache["v"], pos2d,
                                 kpos, scale=scale, causal=causal,
                                 window=window, cap=cfg.attn_softcap,
                                 k_valid=kpos >= 0)
    out = out.reshape(B, S, -1)
    rows = p.wo.shape[0]
    if srv is not None and rows < out.shape[-1]:
        # every head here, wo row-parallel: this rank's heads
        out = out[..., srv.model_rank * rows:(srv.model_rank + 1) * rows]
    return PAR.block_out(L.row_product(out, p.wo, split), split, dt), cache


def _local_kv(p, k, v, cfg: ModelConfig, hl: int):
    """k/v (B,S,cols) of a training rank computing ``hl`` query heads ->
    the kv heads those heads read, (B,S,Hkv_l,hd) each.  When the kv
    heads divide over ``model`` the local columns are those heads.  Else
    the columns are gathered over ``model`` (a whole ``wk`` is already
    all of them, and its gradient is this rank's part) and the heads of
    the local query heads taken: one slice when they group evenly, else
    one kv head per query head."""
    act = PAR.current()
    B, S = k.shape[:2]
    hd, Hkv = cfg.head_dim, cfg.num_kv_heads
    if k.shape[-1] < cfg.kv_dim and Hkv % act.model == 0:
        return k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)
    if k.shape[-1] < cfg.kv_dim:
        k, v = act.gather_cols(k), act.gather_cols(v)
    else:
        PAR.mark_partial(p.wk, p.wv, *((p.bk, p.bv) if cfg.qkv_bias
                                       else ()))
    G = cfg.num_heads // Hkv
    first = act.model_rank * hl
    heads = [(first + j) // G for j in range(hl)]
    lo, n = heads[0], heads[-1] + 1 - heads[0]
    sel = slice(lo, lo + n) if hl % n == 0 and heads == [
        lo + j // (hl // n) for j in range(hl)] else heads
    # a head slice is a strided view: the flash kernel takes it contiguous
    return (k.reshape(B, S, Hkv, hd)[:, :, sel].contiguous(),
            v.reshape(B, S, Hkv, hd)[:, :, sel].contiguous())


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): expanded without a cache, absorbed-MQA with one
# ---------------------------------------------------------------------------
def _mla_layer(p, x, positions, cfg: ModelConfig, cache, cache_offset):
    """MLA on this rank's heads: the column slices of ``wq``, ``w_uk``
    and ``w_uv`` and the row slice of ``wo`` (all of them on one
    device).  Returns (output, cache)."""
    m = cfg.mla
    H, nope, rope = cfg.num_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    hl = p.wo.shape[0] // m.v_head_dim
    split = hl < H
    if split and (H % hl or p.wq.shape[1] != hl * (nope + rope)
                  or p.w_uk.shape[1] != hl * nope
                  or p.w_uv.shape[1] != hl * m.v_head_dim):
        raise ValueError(f"{cfg.name}: MLA's {H} heads do not split into "
                         "whole heads over model")
    x = PAR.block_in(x, split)
    if split:       # the latent, whole, feeds this rank's heads only
        PAR.mark_partial(p.w_dkv, p.kv_norm)
    B, S, _ = x.shape
    dt = x.dtype
    pos2d = positions if positions.dim() == 2 else positions[0]
    # the query/key head dim is nope + rope (192 for V2-Lite), not head_dim;
    # under YaRN the published scale is multiplied by mscale(factor,
    # mscale_all_dim)^2 (1.5896 for V2-Lite), on both paths below
    scale = 1.0 / math.sqrt(nope + rope)
    if cfg.yarn.mscale_all_dim:
        scale *= L.yarn_mscale(cfg.yarn.factor, cfg.yarn.mscale_all_dim) ** 2
    q = (x @ p.wq.to(dt)).reshape(B, S, hl, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    angles = L.rope_angles(positions, rope, cfg.rope_theta, yarn=cfg.yarn)
    ms = L.rope_mscale(cfg.yarn)
    q_rope = L.apply_rope(q_rope, angles, ms)
    ckr = x @ p.w_dkv.to(dt)
    ckv, k_rope = ckr[..., :m.kv_lora_rank], ckr[..., m.kv_lora_rank:]
    ckv = L.rms_norm(ckv, p.kv_norm, cfg.norm_eps)
    k_rope = L.apply_rope(k_rope[:, :, None, :], angles, ms)[:, :, 0, :]

    w_uk = p.w_uk.to(dt).reshape(m.kv_lora_rank, hl, nope)
    w_uv = p.w_uv.to(dt).reshape(m.kv_lora_rank, hl, m.v_head_dim)

    if cache is None:
        # expanded path: per-head k/v materialized from the latent
        k_nope = torch.einsum("btr,rhd->bthd", ckv, w_uk)
        v = torch.einsum("btr,rhd->bthd", ckv, w_uv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, hl, rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = _run_attention(cfg, q, k, v, pos2d, pos2d, scale=scale,
                             causal=True, window=0, cap=0.0)
    else:
        # absorbed path: attention in latent space == MQA with Dk = rank +
        # rope, Dv = rank; the cache holds only (ckv, krope)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        q_abs = torch.cat([q_lat, q_rope], dim=-1)
        srv = PAR.serving()
        new = {"ckv": ckv, "krope": k_rope}
        len_axis = None
        if srv is None:
            cache = update_cache(cache, new, cache_offset, pos2d)
            kpos = cache["pos"]
        else:
            T = cache_len(cfg, GLOBAL_ATTN, srv.max_len)
            len_axis = srv.cache_spec("ckv", (srv.batch, T,
                                              m.kv_lora_rank))[1]
            kpos = _write_sharded(
                srv, cache, new, cache_offset, pos2d, T, len_axis,
                srv.cache_spec("pos", (srv.batch, T))[1])
        k_abs = torch.cat([cache["ckv"], cache["krope"]], dim=-1)[:, :, None]
        v_abs = cache["ckv"][:, :, None]
        if len_axis is None:
            ctx = _run_attention(cfg, q_abs, k_abs, v_abs, pos2d, kpos,
                                 scale=scale, causal=True, window=0,
                                 cap=0.0, k_valid=kpos >= 0)
        else:
            # a slice of the length: every head attends it (the latent
            # queries gathered when the heads go over the same axis)
            every = len_axis == "model" and split
            if every:
                q_abs = srv.all_gather(q_abs, ("model",), dim=2)
            ctx = _length_sharded(cfg, srv, len_axis, q_abs, k_abs, v_abs,
                                  kpos, pos2d, scale=scale, window=0,
                                  cap=0.0)
            if every:
                ctx = ctx[:, :, srv.model_rank * hl:(srv.model_rank + 1) * hl]
        out = torch.einsum("bshr,rhd->bshd", ctx, w_uv)
    out = out.reshape(B, S, hl * m.v_head_dim)
    return PAR.block_out(L.row_product(out, p.wo, split), split, dt), cache


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------
class CrossAttention(nn.Module):
    """Whisper decoder cross-attention weights (always dense MHA, no
    rope): ``wq`` (d, q_dim), ``wk`` / ``wv`` (d, q_dim), ``wo``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        pd, d = L.pdtype_of(cfg), cfg.d_model
        self.wq = L.param(L.dense_init(gen, d, cfg.q_dim, pd))
        self.wk = L.param(L.dense_init(gen, d, cfg.q_dim, pd))
        self.wv = L.param(L.dense_init(gen, d, cfg.q_dim, pd))
        self.wo = L.param(L.dense_init(gen, cfg.q_dim, d, pd))


def _cross_axis(srv, cfg: ModelConfig, T: int):
    """(heads over model, the mesh axis of the frames or None) of the
    cross K/V cache of T frames under the serving layout ``srv``."""
    spec = srv.cache_spec("xk", (srv.batch, T, cfg.num_heads,
                                 cfg.head_dim))
    return spec[2] is not None, spec[1]


def cross_attention_layer(p, x: torch.Tensor, enc_kv, cfg: ModelConfig
                          ) -> torch.Tensor:
    """x: (B,S,d); enc_kv: (k, v) precomputed from the encoder output,
    (B,T,H,D) each (this rank's heads, or its frames, in a shard).  Every
    query sees every frame."""
    split = p.wo.shape[0] < cfg.q_dim
    x = PAR.block_in(x, split)
    dt = x.dtype
    B, S, _ = x.shape
    k, v = enc_kv
    T = k.shape[1]
    q = x @ p.wq.to(dt)
    srv = PAR.serving()
    axis = None
    if srv is not None:
        heads, axis = _cross_axis(srv, cfg, cfg.num_audio_frames)
        if not heads:       # the cache holds every head: whole q
            q = srv.gather_cols(q, cfg.q_dim)
    q = q.reshape(B, S, -1, cfg.head_dim)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    pallas_decode = cfg.attn_impl == "pallas" and S == 1
    if pallas_decode:
        from repro_torch.kernels import ops as kops
        # Every frame counts: the fill is T in every row, inactive slots
        # included (their output is dropped, as under ``chunked``, which
        # attends all frames).  The JAX package passes q_pos[:, 0] = 0
        # here, so its kernel attends no frame and the cross term is 0;
        # ``_run_attention``'s q_pos + 1 would attend frame 0 alone.
        fill = torch.full((B,), T, dtype=torch.int32, device=x.device)
    else:
        pos_q = torch.zeros((B, S), dtype=torch.int32, device=x.device)
        pos_k = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    if axis is not None:
        # this rank's frames, every head: merged by log-sum-exp
        if pallas_decode:
            o, lse = kops.decode_attention(q, k, v, fill, scale=scale,
                                           return_lse=True)
            lse = lse[:, None]
        else:
            o, lse = _chunked_attention(q, k, v, pos_q, pos_k, scale=scale,
                                        causal=False, chunk=cfg.attn_chunk,
                                        return_lse=True)
        out = srv.merge_lse(o, lse, axis)
    elif pallas_decode:
        out = kops.decode_attention(q, k, v, fill, scale=scale)
    else:
        # a chunk of T queries is cache-free and takes the flash kernel
        # (non-causal) under ``pallas``; other lengths the plain paths
        out = _run_attention(cfg, q, k, v, pos_q, pos_k, scale=scale,
                             causal=False, window=0, cap=0.0)
    out = out.reshape(B, S, -1)
    rows = p.wo.shape[0]
    if rows < out.shape[-1]:
        # every head here, wo row-parallel: this rank's heads
        out = out[..., srv.model_rank * rows:(srv.model_rank + 1) * rows]
    return PAR.block_out(L.row_product(out, p.wo, split), split, dt)


def encode_cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K/V from the encoder output: (B,T,H,D)
    each, contiguous (the decode kernel reads them through their
    strides).  On the column slices of ``wk`` / ``wv``: this rank's heads;
    under a serving layout, laid out as the cache rule places them (this
    rank's heads, or every head over this rank's frames, or whole)."""
    split = p.wk.shape[1] < cfg.q_dim
    enc_out = PAR.block_in(enc_out, split)
    dt = enc_out.dtype
    B, T, _ = enc_out.shape
    k = enc_out @ p.wk.to(dt)
    v = enc_out @ p.wv.to(dt)
    srv = PAR.serving()
    if srv is not None:
        if T != cfg.num_audio_frames:
            raise ValueError(f"{cfg.name}: a mesh serves "
                             f"{cfg.num_audio_frames} encoder frames, not {T}")
        heads, axis = _cross_axis(srv, cfg, T)
        if not heads:
            k = srv.gather_cols(k, cfg.q_dim)
            v = srv.gather_cols(v, cfg.q_dim)
        if axis is not None:
            n = srv.sizes[axis]
            lo = srv.coord[axis] * (T // n)
            k, v = k[:, lo:lo + T // n], v[:, lo:lo + T // n]
    shape = (B, k.shape[1], -1, cfg.head_dim)
    return k.reshape(shape).contiguous(), v.reshape(shape).contiguous()
