"""Encoder-decoder backbone (whisper-large-v3).  The frontend is a stub:
the encoder takes precomputed frame embeddings (B, T_enc, d_model).
Positions are sinusoidal and absolute (parameter-free).

The model is an ``nn.Module`` whose encoder and decoder layers sit in two
flat ``ModuleList``s and run in plain loops (the JAX package stacks each
on a leading layer axis and scans it; ``weights.params_from_jax``
unstacks them).  The serving cache holds one dict per decoder layer: the
self-attention's ``k`` / ``v`` / ``pos`` and the layer's cross K/V
``xk`` / ``xv`` (B, T_enc, H, D), which the first prefill fills when it
is given frames and nothing else changes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import Attention, _remat, _zeros


class EncoderLayer(nn.Module):
    """Pre-norm residual layer: self-attention, then the gated MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dev = gen.device
        self.norm1 = _zeros(cfg.d_model, cfg, dev)
        self.mixer = Attention(cfg, gen)
        self.norm2 = _zeros(cfg.d_model, cfg, dev)
        self.mlp = L.MLP(cfg, gen, cfg.d_ff)

    def forward(self, x, positions, cfg: ModelConfig):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        mix, _ = A.attention_layer(self.mixer, h, positions, cfg,
                                   GLOBAL_ATTN, causal=False)
        x = x + mix
        h2 = L.rms_norm(x, self.norm2, cfg.norm_eps)
        return x + self.mlp(h2, cfg.mlp_act)


class DecoderLayer(EncoderLayer):
    """An encoder layer with a cross-attention over the encoder output
    (``norm_x``, ``cross``) between its causal self-attention and its
    MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__(cfg, gen)
        self.norm_x = _zeros(cfg.d_model, cfg, gen.device)
        self.cross = A.CrossAttention(cfg, gen)

    def forward(self, x, positions, cfg: ModelConfig, xk, xv, cache=None,
                offsets=None):
        h = L.rms_norm(x, self.norm1, cfg.norm_eps)
        mix, _ = A.attention_layer(self.mixer, h, positions, cfg,
                                   GLOBAL_ATTN, cache, offsets)
        x = x + mix
        hx = L.rms_norm(x, self.norm_x, cfg.norm_eps)
        x = x + A.cross_attention_layer(self.cross, hx, (xk, xv), cfg)
        h2 = L.rms_norm(x, self.norm2, cfg.norm_eps)
        return x + self.mlp(h2, cfg.mlp_act)


class EncDec(nn.Module):
    """Whisper backbone; the LM head is the embedding table (tied) or
    ``lm_head`` (d, V).  ``self.cfg`` (attention implementation included)
    is read at every call."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        pd, dev = L.pdtype_of(cfg), gen.device
        self.embed = L.param(L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          pd))
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = L.param(L.dense_init(gen, cfg.d_model,
                                                cfg.vocab_size, pd))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, gen) for _ in range(cfg.encoder_layers))
        self.enc_norm = _zeros(cfg.d_model, cfg, dev)
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, gen) for _ in range(cfg.num_layers))
        self.final_norm = _zeros(cfg.d_model, cfg, dev)

    def _remat(self, cache):
        return (_remat(self.cfg) if cache is None and torch.is_grad_enabled()
                else None)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, d_model) stub embeddings -> encoder output,
        non-causal self-attention over every frame."""
        cfg = self.cfg
        B, T, _ = frames.shape
        x = frames.to(L.dtype_of(cfg))
        x = x + L.sinusoidal_positions(T, cfg.d_model,
                                       x.device).to(x.dtype)[None]
        pos = torch.arange(T, dtype=torch.int32,
                           device=x.device)[None].expand(B, T)
        remat = self._remat(None)
        for layer in self.enc_layers:
            x = (layer(x, pos, cfg) if remat is None
                 else remat(layer, x, pos, cfg))
        return L.rms_norm(x, self.enc_norm, cfg.norm_eps)

    def prepare_cross(self, enc_out: torch.Tensor
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each decoder layer's cross (K, V) from the encoder output."""
        return [A.encode_cross_kv(layer.cross, enc_out, self.cfg)
                for layer in self.dec_layers]

    def decode(self, tokens: torch.Tensor, positions: torch.Tensor, *,
               enc_out: Optional[torch.Tensor] = None,
               cache: Optional[List[dict]] = None,
               lengths: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Optional[List[dict]]]:
        """Decoder forward -> (logits fp32, cache).  Train: ``enc_out``
        given, cache None.  Serve: the cache holds each layer's self K/V
        (written in place at ``lengths``) and its cross K/V."""
        cfg = self.cfg
        x = L.embed_lookup(self.embed, tokens, cfg)
        pos2d = positions if positions.dim() == 2 else positions[0]
        x = x + L.sinusoidal_at(pos2d, cfg.d_model).to(x.dtype)
        remat = self._remat(cache)
        cross = self.prepare_cross(enc_out) if cache is None else None
        for i, layer in enumerate(self.dec_layers):
            if cache is None:
                args = (x, pos2d, cfg, *cross[i])
                x = layer(*args) if remat is None else remat(layer, *args)
            else:
                c = cache[i]
                x = layer(x, pos2d, cfg, c["xk"], c["xv"], c, lengths)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return L.lm_logits(x, self.embed, self.lm_head, cfg), cache


def init_model(cfg: ModelConfig, gen: torch.Generator) -> EncDec:
    """Random weights from ``gen``, on ``gen.device``."""
    return EncDec(cfg, gen)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> List[dict]:
    """One dict per decoder layer: self-attention ``k`` / ``v`` / ``pos``
    and zeroed cross K/V slots ``xk`` / ``xv`` (B, num_audio_frames, H,
    D)."""
    shape = (batch, cfg.num_audio_frames, cfg.num_heads, cfg.head_dim)
    dt = L.dtype_of(cfg)
    return [dict(A.init_kv_cache(cfg, GLOBAL_ATTN, batch, max_len, device),
                 xk=torch.zeros(shape, dtype=dt, device=device),
                 xv=torch.zeros(shape, dtype=dt, device=device))
            for _ in range(cfg.num_layers)]
