"""Decoder-only LM assembly: attention (GQA or MLA), SSD and RG-LRU
blocks, dense or MoE feed-forwards, caches.

The model is an ``nn.Module`` whose layers sit in a flat ``ModuleList``
and run in a plain loop (the JAX package scans stacked layer groups
after its leading dense ``front`` layers; ``layer_layout`` keeps its
partition so ``weights.params_from_jax`` can unstack them).  Weights are
random, drawn from an explicit ``torch.Generator`` on the generator's
device.  Each layer kind carries its own cache dict.  The encoder-decoder
stack (whisper) is ``models/encdec.py``.

Under a sharded train step with ``seq`` (``distributed/parallel.py``)
the residual stream holds this rank's positions: the norms and the
residual adds run on them, each block enters and leaves through
``block_in`` / ``block_out``, and the LM head gathers the sequence.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.distributed import parallel as PAR
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SM


# ---------------------------------------------------------------------------
# layer layout
# ---------------------------------------------------------------------------
def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def layer_layout(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(front, group_len, n_groups, tail) layer partition of the JAX
    package's parameter tree."""
    front = cfg.moe.first_dense_layers if cfg.moe else 0
    p = len(cfg.block_pattern)
    if cfg.moe:
        p = _lcm(p, cfg.moe.layer_period)
    rest = cfg.num_layers - front
    n_groups = rest // p if cfg.scan_layers else 0
    tail = rest - n_groups * p
    return front, p, n_groups, tail


def _zeros(n: int, cfg: ModelConfig, device) -> nn.Parameter:
    return L.param(torch.zeros(n, dtype=L.pdtype_of(cfg), device=device))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """GQA or MLA projections (``x @ w`` layout, as the JAX package stores
    them)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        pd, d, dev = L.pdtype_of(cfg), cfg.d_model, gen.device
        if cfg.mla is not None:
            m, H = cfg.mla, cfg.num_heads
            qd = H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            self.wq = L.param(L.dense_init(gen, d, qd, pd))
            self.w_dkv = L.param(L.dense_init(
                gen, d, m.kv_lora_rank + m.qk_rope_head_dim, pd))
            self.kv_norm = _zeros(m.kv_lora_rank, cfg, dev)
            self.w_uk = L.param(L.dense_init(
                gen, m.kv_lora_rank, H * m.qk_nope_head_dim, pd))
            self.w_uv = L.param(L.dense_init(
                gen, m.kv_lora_rank, H * m.v_head_dim, pd))
            self.wo = L.param(L.dense_init(gen, H * m.v_head_dim, d, pd))
            return
        self.wq = L.param(L.dense_init(gen, d, cfg.q_dim, pd))
        self.wk = L.param(L.dense_init(gen, d, cfg.kv_dim, pd))
        self.wv = L.param(L.dense_init(gen, d, cfg.kv_dim, pd))
        self.wo = L.param(L.dense_init(gen, cfg.q_dim, d, pd))
        if cfg.qkv_bias:
            self.bq = _zeros(cfg.q_dim, cfg, dev)
            self.bk = _zeros(cfg.kv_dim, cfg, dev)
            self.bv = _zeros(cfg.kv_dim, cfg, dev)
        if cfg.qk_norm:
            self.q_norm = _zeros(cfg.head_dim, cfg, dev)
            self.k_norm = _zeros(cfg.head_dim, cfg, dev)


class DecoderLayer(nn.Module):
    """Pre-norm residual layer: an attention, SSD or RG-LRU mixer, then
    (except SSD, which has none) the gated MLP, or on an MoE layer the
    experts (``moe``, in place of ``mlp``)."""

    def __init__(self, cfg: ModelConfig, kind: str, is_moe: bool,
                 gen: torch.Generator):
        super().__init__()
        dev = gen.device
        self.kind = kind
        self.is_moe = is_moe
        self.norm1 = _zeros(cfg.d_model, cfg, dev)
        if kind in (GLOBAL_ATTN, LOCAL_ATTN):
            self.mixer = Attention(cfg, gen)
        elif kind == SSD:
            self.mixer = SM.SSD(cfg, gen)
        elif kind == RGLRU:
            self.mixer = R.RGLRU(cfg, gen)
        else:
            raise ValueError(kind)
        if cfg.use_post_norms:
            self.post_norm1 = _zeros(cfg.d_model, cfg, dev)
        if kind == SSD:
            return          # the SSD block has no separate MLP
        self.norm2 = _zeros(cfg.d_model, cfg, dev)
        if is_moe:
            self.moe = M.MoE(cfg, gen)
        else:
            self.mlp = L.MLP(cfg, gen, cfg.d_ff)
        if cfg.use_post_norms:
            self.post_norm2 = _zeros(cfg.d_model, cfg, dev)

    def forward(self, x, positions, cfg: ModelConfig, cache=None,
                offsets=None, valid=None, moe_impl: str = "gshard"):
        """Returns (x, cache, MoE aux loss or None)."""
        if PAR.seq_sharded():       # the norms see this rank's positions
            PAR.mark_partial(*self.parameters(recurse=False))
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind in (SSD, RGLRU):
            block = SM.ssd_block if self.kind == SSD else R.rglru_block
            mix, cache = block(self.mixer, h, cfg, cache, valid)
        else:
            mix, cache = A.attention_layer(self.mixer, h, positions, cfg,
                                           self.kind, cache, offsets)
        if cfg.use_post_norms:
            mix = L.rms_norm(mix, self.post_norm1, cfg.norm_eps)
        x = x + mix
        if self.kind == SSD:
            return x, cache, None
        h2 = L.rms_norm(x, self.norm2, cfg.norm_eps)
        aux = None
        if self.is_moe:
            y, aux = M.apply_moe(self.moe, h2, cfg, moe_impl, valid)
        else:
            y = self.mlp(h2, cfg.mlp_act)
        if cfg.use_post_norms:
            y = L.rms_norm(y, self.post_norm2, cfg.norm_eps)
        return x + y, cache, aux


class Transformer(nn.Module):
    """Decoder-only LM; the LM head is the embedding table (tied) or
    ``lm_head`` (d, V).  ``self.cfg`` (attention implementation
    included) is read at every forward."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        pd = L.pdtype_of(cfg)
        self.embed = L.param(L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          pd))
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = L.param(L.dense_init(gen, cfg.d_model,
                                                cfg.vocab_size, pd))
        self.final_norm = _zeros(cfg.d_model, cfg, gen.device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, is_moe, gen) for kind, is_moe in
            zip(cfg.pattern_for_layers(), cfg.moe_layer_mask()))

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[List[dict]] = None,
                lengths: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                vis_embeds: Optional[torch.Tensor] = None,
                vis_mask: Optional[torch.Tensor] = None,
                moe_impl: str = "gshard",
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[List[dict]]]:
        """Returns (logits fp32, MoE aux loss summed over layers, cache).

        Train/prefill-from-zero: cache=None.  Serving: cache + lengths (B,)
        = current fill; positions must be absolute, (B,S) or (3,B,S) for
        M-RoPE (the caches store the first stream); ``valid`` (B,S) marks
        the real tokens of a ragged chunk (the recurrent blocks keep their
        state unchanged across the rest).  VLM stub: ``vis_embeds``
        (B,S,d) replace the token embeddings where ``vis_mask`` (B,S) is
        set.  Attention caches are written in place; a recurrent layer
        replaces the entries of its cache dict."""
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        if vis_embeds is not None:
            x = torch.where(vis_mask[..., None], vis_embeds.to(x.dtype), x)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = _remat(self.cfg) if cache is None \
            and torch.is_grad_enabled() else None
        for i, layer in enumerate(self.layers):
            c = cache[i] if cache is not None else None
            args = (x, positions, self.cfg, c, lengths, valid, moe_impl)
            x, _, aux = (layer(*args) if remat is None
                         else remat(layer, *args))
            if aux is not None:
                aux_total = aux_total + aux
        if PAR.seq_sharded():
            PAR.mark_partial(self.final_norm)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return (L.lm_logits(x, self.embed, self.lm_head, self.cfg),
                aux_total, cache)


# ---------------------------------------------------------------------------
# rematerialisation (the JAX package's ``_remat``, per layer)
# ---------------------------------------------------------------------------
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    # jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims keeps the
    # dot products with no batch dims: the weight matmuls, which torch runs
    # as mm/addmm on the flattened (B*S, d) activations; the attention
    # products (bmm, batched) are recomputed, as there
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig):
    """``cfg.remat`` as a per-layer ``checkpoint`` call, or None.

    ``full`` keeps only each layer's input and recomputes the layer in
    the backward (so its attention forward runs twice per step); ``dots``
    also keeps the outputs of the matmuls (selective checkpointing);
    ``none`` keeps everything."""
    if cfg.remat == "none":
        return None
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r} "
                         "(expected full | dots | none)")
    return functools.partial(ckpt.checkpoint, **kw)


# ---------------------------------------------------------------------------
# init / caches / positions
# ---------------------------------------------------------------------------
def init_model(cfg: ModelConfig, gen: torch.Generator) -> Transformer:
    """Random weights from ``gen``, on ``gen.device``."""
    return Transformer(cfg, gen)


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device) -> dict:
    if kind in (GLOBAL_ATTN, LOCAL_ATTN):
        return A.init_kv_cache(cfg, kind, batch, max_len, device)
    if kind == SSD:
        return SM.init_ssd_cache(cfg, batch, device)
    if kind == RGLRU:
        return R.init_rglru_cache(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> List[dict]:
    """One cache dict per layer: k/v/pos for attention, conv windows and
    state for SSD, conv window and h for RG-LRU."""
    return [_layer_cache(cfg, kind, batch, max_len, device)
            for kind in cfg.pattern_for_layers()]


def make_positions(cfg: ModelConfig, batch: int, seq: int, device,
                   start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,S) int32 positions ``start + arange(S)``, or (3,B,S) identical
    streams for M-RoPE text."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if start is not None:
        pos = pos + start.to(torch.int32)[:, None]
    if cfg.mrope_sections:
        pos = pos[None].expand(3, batch, seq)
    return pos
