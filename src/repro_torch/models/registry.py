"""Model API over the decoder-only and encoder-decoder stacks.

``build_model(cfg)`` returns a ``Model`` with:
  init(gen)                                      -> module (on gen.device)
  forward(module, batch)                         -> (logits, aux)   # train
  init_cache(batch, max_len, device)             -> cache
  prefill(module, tokens, cache, lengths, valid) -> (logits, cache)
  decode_step(module, tokens, cache, lengths, valid) -> (logits, cache)

``batch`` is a dict; see ``input_names(cfg, kind)`` for the contract.
``aux`` is the MoE auxiliary loss summed over layers, 0 without MoE.
``moe_impl`` picks the MoE dispatch (``ragged`` by default, as in the
JAX package; the training step passes ``gshard``, the serving step
``gshard`` or, where ``cfg.moe.serve_impl`` asks, ``grouped``).
The encoder-decoder model's ``forward`` batch carries ``frames``, and its
``prefill`` takes ``frames=`` to encode them and fill every layer's cross
K/V; the engine never passes frames, so it serves over the zero cross
K/V of ``init_cache``, as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], torch.nn.Module]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., list]
    prefill: Callable[..., Tuple[torch.Tensor, list]]
    decode_step: Callable[..., Tuple[torch.Tensor, list]]


def input_names(cfg: ModelConfig, kind: str) -> Tuple[str, ...]:
    if cfg.is_encoder_decoder:
        if kind == "train":
            return ("frames", "tokens", "labels")
        return ("tokens",)
    if cfg.frontend_stub:  # vlm
        if kind == "train":
            return ("tokens", "vis_embeds", "vis_mask", "labels")
        return ("tokens",)
    if kind == "train":
        return ("tokens", "labels")
    return ("tokens",)


def build_model(cfg: ModelConfig, moe_impl: str = "ragged") -> Model:
    if cfg.is_encoder_decoder:
        return _build_encdec(cfg)
    return _build_decoder_only(cfg, moe_impl)


def _build_decoder_only(cfg: ModelConfig, moe_impl: str) -> Model:
    def init(gen):
        return transformer.init_model(cfg, gen)

    def forward(module, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = transformer.make_positions(cfg, B, S, tokens.device)
        logits, aux, _ = module(tokens, positions,
                                vis_embeds=batch.get("vis_embeds"),
                                vis_mask=batch.get("vis_mask"),
                                moe_impl=moe_impl)
        return logits, aux

    def init_cache(batch, max_len, device):
        return transformer.init_cache(cfg, batch, max_len, device)

    def prefill(module, tokens, cache, lengths, valid=None, **kw):
        """``valid`` (B,S) bool: ragged chunk tails / inactive decode slots.
        Pad entries are written with position -1 (never attended, ring-
        overwritten later)."""
        B, S = tokens.shape
        positions = transformer.make_positions(cfg, B, S, tokens.device,
                                               start=lengths)
        if valid is not None:
            vmask = valid if positions.dim() == 2 else valid[None]
            positions = torch.where(vmask, positions, -1)
        logits, _, cache = module(tokens, positions, cache=cache,
                                  lengths=lengths, valid=valid,
                                  vis_embeds=kw.get("vis_embeds"),
                                  vis_mask=kw.get("vis_mask"),
                                  moe_impl=moe_impl)
        return logits, cache

    def decode_step(module, tokens, cache, lengths, valid=None):
        return prefill(module, tokens, cache, lengths, valid=valid)

    return Model(cfg, init, forward, init_cache, prefill, decode_step)


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(gen):
        return encdec.init_model(cfg, gen)

    def forward(module, batch):
        frames, tokens = batch["frames"], batch["tokens"]
        B, S = tokens.shape
        enc_out = module.encode(frames)
        positions = transformer.make_positions(cfg, B, S, tokens.device)
        logits, _ = module.decode(tokens, positions, enc_out=enc_out)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def init_cache(batch, max_len, device):
        return encdec.init_cache(cfg, batch, max_len, device)

    def prefill(module, tokens, cache, lengths, frames=None, valid=None,
                **kw):
        """A call given ``frames`` (B, T_enc, d) encodes them and fills
        every layer's cross K/V first."""
        if frames is not None:
            cross = module.prepare_cross(module.encode(frames))
            for c, (xk, xv) in zip(cache, cross):
                c["xk"], c["xv"] = xk, xv
        B, S = tokens.shape
        positions = transformer.make_positions(cfg, B, S, tokens.device,
                                               start=lengths)
        if valid is not None:
            positions = torch.where(valid, positions, -1)
        logits, cache = module.decode(tokens, positions, cache=cache,
                                      lengths=lengths)
        return logits, cache

    def decode_step(module, tokens, cache, lengths, valid=None):
        return prefill(module, tokens, cache, lengths, valid=valid)

    return Model(cfg, init, forward, init_cache, prefill, decode_step)
