"""Public entry points of the port's kernels, in model layout.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
PyTorch version (``kernels/ref.py``); a CUDA tensor launches the
hand-written kernel, which raises on anything it does not take.  Nothing
falls back from the kernel to the plain version.

``LAUNCHES`` counts kernel launches per kernel name (plain ints): the
main path's launches are read from it after a run that set it to zero.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.ref import decode_attention_ref

LAUNCHES: Dict[str, int] = {"decode_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def decode_attention(q, k, v, lengths, *, scale: float, window: int = 0,
                     cap: float = 0.0) -> torch.Tensor:
    """q: (B,1,Hq,D); k/v: (B,T,Hkv,D); lengths: (B,) -> (B,1,Hq,D).

    Keys ``kpos < lengths[b]`` (and within ``window`` of the length)
    count; rows with a length <= 0 return 0."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale=scale,
                                    window=window, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    out = decode_attention_cuda(q, k, v, lengths.to(torch.int32), scale=scale,
                                window=window, cap=cap)
    LAUNCHES["decode_attention"] += 1
    return out
