"""Model API over the decoder-only stack.

``build_model(cfg)`` returns a ``Model`` with:
  init(gen)                                      -> module (on gen.device)
  forward(module, batch)                         -> (logits, aux)   # train
  init_cache(batch, max_len, device)             -> cache
  prefill(module, tokens, cache, lengths, valid) -> (logits, cache)
  decode_step(module, tokens, cache, lengths, valid) -> (logits, cache)

``batch`` is a dict holding ``tokens`` and optionally ``positions``.
``aux`` is the MoE auxiliary loss, 0 for the dense decoder.
Encoder-decoder models are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], transformer.Transformer]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., list]
    prefill: Callable[..., Tuple[torch.Tensor, list]]
    decode_step: Callable[..., Tuple[torch.Tensor, list]]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.is_encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported yet")
    return _build_decoder_only(cfg)


def _build_decoder_only(cfg: ModelConfig) -> Model:
    def init(gen):
        return transformer.init_model(cfg, gen)

    def forward(module, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = transformer.make_positions(B, S, tokens.device)
        logits, _ = module(tokens, positions)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def init_cache(batch, max_len, device):
        return transformer.init_cache(cfg, batch, max_len, device)

    def prefill(module, tokens, cache, lengths, valid=None):
        """``valid`` (B,S) bool: ragged chunk tails / inactive decode slots.
        Pad entries are written with position -1 (never attended, ring-
        overwritten later)."""
        B, S = tokens.shape
        positions = transformer.make_positions(B, S, tokens.device,
                                               start=lengths)
        if valid is not None:
            positions = torch.where(valid, positions, -1)
        return module(tokens, positions, cache=cache, lengths=lengths)

    def decode_step(module, tokens, cache, lengths, valid=None):
        return prefill(module, tokens, cache, lengths, valid=valid)

    return Model(cfg, init, forward, init_cache, prefill, decode_step)
