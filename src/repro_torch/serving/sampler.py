"""Token sampling: greedy / temperature / top-k, batched."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, *, temperature: float = 0.0,
           top_k: int = 0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: (B, V) fp32 -> (B,) int32.

    temperature == 0 => greedy; ties go to the first maximum, as
    ``jnp.argmax`` breaks them.  top_k > 0 restricts to the k best before
    the categorical draw, which takes its randomness from ``generator``.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    scaled = logits / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
