"""Decoder-only LM assembly: attention, SSD and RG-LRU blocks, caches.

The model is an ``nn.Module`` whose layers sit in a flat ``ModuleList``
and run in a plain loop (the JAX package scans stacked layer groups;
``layer_layout`` keeps its partition so ``weights.params_from_jax`` can
unstack them).  Weights are random, drawn from an explicit
``torch.Generator`` on the generator's device.  Each layer kind carries
its own cache dict.  MoE blocks are not ported yet.
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
from repro_torch.models import attention as A
from repro_torch.models import layers as L
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


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.moe is not None or any(cfg.moe_layer_mask()):
        raise NotImplementedError("MoE blocks are not ported yet")
    if cfg.mla is not None or cfg.is_encoder_decoder or cfg.mrope_sections:
        raise NotImplementedError(
            "MLA, encoder-decoder and M-RoPE models are not ported yet")
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied LM heads are not ported yet")


def _zeros(n: int, cfg: ModelConfig, device) -> nn.Parameter:
    return L.param(torch.zeros(n, dtype=L.pdtype_of(cfg), device=device))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """GQA projections (``x @ w`` layout, as the JAX package stores them)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        pd, d, dev = L.pdtype_of(cfg), cfg.d_model, gen.device
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


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        pd, d = L.pdtype_of(cfg), cfg.d_model
        self.w_gate = L.param(L.dense_init(gen, d, cfg.d_ff, pd))
        self.w_up = L.param(L.dense_init(gen, d, cfg.d_ff, pd))
        self.w_down = L.param(L.dense_init(gen, cfg.d_ff, d, pd))

    def forward(self, x: torch.Tensor, act: str) -> torch.Tensor:
        return L.apply_mlp(self.w_gate, self.w_up, self.w_down, x, act)


class DecoderLayer(nn.Module):
    """Pre-norm residual layer: an attention, SSD or RG-LRU mixer, then
    (except SSD, which has none) the gated MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator):
        super().__init__()
        dev = gen.device
        self.kind = kind
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
        self.mlp = MLP(cfg, gen)
        if cfg.use_post_norms:
            self.post_norm2 = _zeros(cfg.d_model, cfg, dev)

    def forward(self, x, positions, cfg: ModelConfig, cache=None,
                offsets=None, valid=None):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind == SSD:
            mix, cache = SM.ssd_block(self.mixer, h, cfg, cache, valid)
        elif self.kind == RGLRU:
            mix, cache = R.rglru_block(self.mixer, h, cfg, cache, valid)
        else:
            mix, cache = A.attention_layer(self.mixer, h, positions, cfg,
                                           self.kind, cache, offsets)
        if cfg.use_post_norms:
            mix = L.rms_norm(mix, self.post_norm1, cfg.norm_eps)
        x = x + mix
        if self.kind == SSD:
            return x, cache
        y = self.mlp(L.rms_norm(x, self.norm2, cfg.norm_eps), cfg.mlp_act)
        if cfg.use_post_norms:
            y = L.rms_norm(y, self.post_norm2, cfg.norm_eps)
        return x + y, cache


class Transformer(nn.Module):
    """Decoder-only LM with tied embeddings.  ``self.cfg`` (attention
    implementation included) is read at every forward."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = L.param(L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          L.pdtype_of(cfg)))
        self.final_norm = _zeros(cfg.d_model, cfg, gen.device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, gen) for kind in cfg.pattern_for_layers())

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor, *,
                cache: Optional[List[dict]] = None,
                lengths: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[List[dict]]]:
        """Returns (logits fp32, cache).

        Train/prefill-from-zero: cache=None.  Serving: cache + lengths (B,)
        = current fill; positions must be absolute; ``valid`` (B,S) marks
        the real tokens of a ragged chunk (the recurrent blocks keep their
        state unchanged across the rest).  Attention caches are written
        in place; a recurrent layer replaces the entries of its cache
        dict."""
        x = L.embed_lookup(self.embed, tokens, self.cfg)
        remat = _remat(self.cfg) if cache is None \
            and torch.is_grad_enabled() else None
        for i, layer in enumerate(self.layers):
            if remat is not None:
                x, _ = remat(layer, x, positions, self.cfg)
                continue
            c = cache[i] if cache is not None else None
            x, _ = layer(x, positions, self.cfg, c, lengths, valid)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return L.lm_logits(x, self.embed, self.cfg), cache


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


def make_positions(batch: int, seq: int, device,
                   start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,S) int32 positions ``start + arange(S)``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if start is not None:
        pos = pos + start.to(torch.int32)[:, None]
    return pos
