"""Serving steps: batched chunked-prefill and decode on one device.

``build_serve_fns(cfg, batch=, max_len=, device=)`` returns the
data-plane functions the engine calls:

  * ``prefill_chunk(module, cache, tokens(B,C), lengths(B,), valid_n(B,))``
      -> (next_token (B,), last_logits (B,V), cache)
    Ragged tails are exact: pad entries are written with position -1.
  * ``decode(module, cache, tokens(B,), lengths(B,), active(B,))``
      -> (next_token (B,), cache)
  * ``reset_slots(cache, keep_mask(B,))`` — invalidate freed slots' cache
    rows so re-assigned slots never attend to a previous tenant's KV or
    continue its recurrent state (the paper's memory-isolation
    requirement R3 at the cache level).

The functions run eagerly and update the cache's tensors in place (the
JAX package jits them and donates the cache).  ``device`` is the card
unless the caller asks for ``"cpu"``; without a card the default raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Model, build_model
from repro_torch.serving.sampler import sample


@dataclasses.dataclass
class ServeFns:
    cfg: ModelConfig
    model: Model
    device: torch.device
    init_params: Callable[[int], Any]
    init_cache: Callable[[], Any]
    prefill_chunk: Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]
    decode: Callable[..., Tuple[torch.Tensor, Any]]
    reset_slots: Callable[[Any, torch.Tensor], Any]


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA
    device and no card is present (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def make_reset_slots(cfg: ModelConfig):
    """reset(cache, keep (B,) bool) -> cache with dropped slots invalidated,
    in place: ``pos`` rows set to -1 (k/v payloads are masked by pos) and
    the recurrent rows (``state``, ``h``, ``conv*``) zeroed, so a
    reassigned slot starts from a fresh state, not its last tenant's."""

    def reset(cache, keep):
        drop = ~keep.to(torch.bool)
        for layer in cache:
            for name, t in layer.items():
                rows = drop.reshape((-1,) + (1,) * (t.dim() - 1))
                if name == "pos":
                    t.masked_fill_(rows, -1)
                elif name in ("state", "h") or name.startswith("conv"):
                    t.masked_fill_(rows, 0)
        return cache

    return reset


def build_serve_fns(cfg: ModelConfig, *, batch: int, max_len: int,
                    temperature: float = 0.0, device="cuda") -> ServeFns:
    dev = require_device(device)
    model = build_model(cfg, moe_impl="gshard")

    @torch.no_grad()
    def _prefill(module, cache, tokens, lengths, valid_n):
        B, C = tokens.shape
        valid = torch.arange(C, device=tokens.device)[None, :] \
            < valid_n[:, None]
        logits, cache = model.prefill(module, tokens, cache, lengths,
                                      valid=valid)
        idx = torch.clamp(valid_n.long() - 1, min=0)
        last = logits[torch.arange(B, device=logits.device), idx]  # (B, V)
        nxt = sample(last, temperature=temperature)
        return nxt, last, cache

    @torch.no_grad()
    def _decode(module, cache, tokens, lengths, active):
        logits, cache = model.decode_step(
            module, tokens[:, None], cache, lengths,
            valid=active.to(torch.bool)[:, None])
        nxt = sample(logits[:, -1], temperature=temperature)
        return nxt, cache

    @torch.no_grad()
    def init_params(seed: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return model.init(gen)

    return ServeFns(
        cfg=cfg, model=model, device=dev, init_params=init_params,
        init_cache=lambda: model.init_cache(batch, max_len, dev),
        prefill_chunk=_prefill, decode=_decode,
        reset_slots=make_reset_slots(cfg))
