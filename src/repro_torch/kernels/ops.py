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

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.wlbvt_select import check_limits, wlbvt_select_cuda

LAUNCHES: Dict[str, int] = {"decode_attention": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "wlbvt_select": 0}
WLBVT_IMPLS = ("", "jnp", "jnp_ref", "pallas")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def decode_attention(q, k, v, lengths, *, scale: float, window: int = 0,
                     cap: float = 0.0) -> torch.Tensor:
    """q: (B,1,Hq,D); k/v: (B,T,Hkv,D); lengths: (B,) -> (B,1,Hq,D).

    Keys ``kpos < lengths[b]`` (and within ``window`` of the length)
    count; rows with a length <= 0 return 0."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                    window=window, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    out = decode_attention_cuda(q, k, v, lengths.to(torch.int32), scale=scale,
                                window=window, cap=cap)
    LAUNCHES["decode_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel and, for the gradient, the backward kernel (the
    two plain versions on CPU tensors).  Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, cap):
        kw = dict(scale=scale, causal=causal, window=window, cap=cap)
        dev = q.device.type
        if dev == "cpu":
            o, lse = ref.flash_attention_ref(q, k, v, **kw)
        elif dev == "cuda":
            o, lse = flash_attention_cuda(q, k, v, **kw)
            LAUNCHES["flash_attention"] += 1
        else:
            raise ValueError(f"flash_attention: no kernel for device "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                     **ctx.kw)
        else:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                  **ctx.kw)
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: int = 0, cap: float = 0.0) -> torch.Tensor:
    """Cache-free attention, differentiable.  q: (B,S,Hq,D); k/v:
    (B,T,Hkv,D) -> (B,S,Hq,D).  Query position s sees key t when
    ``t <= s`` (causal) and ``s - t < window`` (window > 0); scores are
    soft-capped to ``cap * tanh(s / cap)`` when cap > 0.

    On a CUDA tensor the forward kernel runs, and the backward kernel
    computes the gradient; a shape they do not take raises."""
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(window), float(cap))[0]


def wlbvt_select_rounds(prio, queue_len, cur_occup, total_occup, bvt,
                        free_k, *, num_pus: int, max_picks: int,
                        impl: str = ""):
    """One WLBVT dispatch round over ``[R, T]`` replica x tenant lanes ->
    ``(picks [R, max_picks] int32 (-1 = no grant), queue_len',
    cur_occup')`` (contract: ``kernels/ref.py::wlbvt_select_rounds_ref``).

    ``impl`` keeps the JAX package's names, so a sweep invocation carries
    across unchanged: ``""`` (auto: the kernel on a CUDA tensor, the
    early-exit plain version on a CPU tensor), ``"jnp"`` (early-exit
    plain version), ``"jnp_ref"`` (dense plain version), ``"pallas"``
    (the CUDA kernel; on a CPU tensor its dense plain version, under the
    kernel's limits T <= 128, max_picks <= 128).  The plain versions are
    for CPU tensors: on a CUDA tensor only the kernel runs."""
    if impl not in WLBVT_IMPLS:
        raise ValueError(f"unknown wlbvt_select impl {impl!r} "
                         "(expected jnp | jnp_ref | pallas)")
    dev = prio.device.type
    if impl == "pallas":      # the kernel's limits, on every device
        check_limits(prio.shape[-1], max_picks)
    args = (prio, queue_len, cur_occup, total_occup, bvt, free_k)
    kw = dict(num_pus=num_pus, max_picks=max_picks)
    if dev == "cpu":
        if impl in ("", "jnp"):
            return ref.wlbvt_select_rounds_early_exit(*args, **kw)
        return ref.wlbvt_select_rounds_ref(*args, **kw)
    if dev != "cuda":
        raise ValueError(f"wlbvt_select_rounds: no kernel for device "
                         f"{prio.device}")
    if impl not in ("", "pallas"):
        raise ValueError(f"wlbvt_select impl {impl!r} is a plain version, "
                         "for CPU tensors; on a CUDA tensor only the kernel "
                         "runs (impl '' or 'pallas')")
    out = wlbvt_select_cuda(*args, **kw)
    LAUNCHES["wlbvt_select"] += 1
    return out
