"""Flash attention on the card: the wrappers of ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (its gradient).

Cache-free self-attention in the model's layout: q (B, S, Hq, D), k/v
(B, T, Hkv, D), read through their strides.  The forward replaces the
Pallas TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel`` and
also returns the per-row log-sum-exp, fp32 (B, Hkv, S * G) with the G
query heads of a KV head folded position-major (row ``s * G + g``); the
backward has no Pallas counterpart (the JAX package trains through XLA's
gradient of its chunked attention).  Their plain versions are
``kernels/ref.py::flash_attention_ref`` and ``flash_attention_bwd_ref``.

Both kernels dispatch on dtype: bfloat16 goes to the Hopper kernels
(``wgmma`` on the tensor cores, K/V by TMA in the forward), float32 to the
exact scalar kernels; at head dim 256 the bfloat16 backward also runs the
scalar kernel (bf16 in, fp32 sums).  Every base address and byte stride of q, k and v
must be a multiple of 16 (TMA and 16-byte copies); ``_check`` raises
otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
HEAD_DIMS = (16, 32, 64, 128, 256)   # the head dims the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SHAPE = [_I] * 6 + [_L] * 9 + [_F, _I, _I, _F, _P]
_FWD_ARGTYPES = [_I, _P, _P, _P, _P, _P] + _SHAPE
_BWD_ARGTYPES = [_I] + [_P] * 10 + _SHAPE
_CONVERT_ARGTYPES = [_P, _P, _L, _P]
_ALIGN = 16                       # bytes: TMA boxes and 16-byte copies


def _lib(name: str, fn: str, argtypes) -> ctypes.CDLL:
    lib = build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    """Raise on any q, k, v the kernels do not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k and v must lie on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: q/k/v must share one dtype "
                         f"of {list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: want q (B,S,Hq,D) and k/v "
                         f"(B,T,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError("flash_attention_cuda: q and k/v shapes disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} is not one the "
                         f"kernels are built for {HEAD_DIMS}")
    if min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention_cuda: empty input")
    if B * S * Hq >= 2**31 or B * k.shape[1] * k.shape[2] >= 2**31:
        raise ValueError("flash_attention_cuda: too many rows for int32 "
                         "row indices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name} needs a "
                             f"contiguous last dim")
        strides = [st * t.element_size() for st in _strides(t)]
        if t.data_ptr() % _ALIGN or any(st % _ALIGN for st in strides):
            raise ValueError(f"flash_attention_cuda: {name}'s address and "
                             f"byte strides {strides} must be multiples of "
                             f"{_ALIGN}")


def _strides(t) -> tuple:
    """The (batch, position, head) strides in elements; a dim of size 1 is
    never stepped, so it gets the head dim (an aligned stand-in) whatever
    stride PyTorch gave it."""
    return tuple(t.stride(i) if t.shape[i] > 1 else t.shape[3]
                 for i in range(3))


def _shape_args(q, k, v, scale, causal, window, cap, stream):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    return (B, S, T, Hkv, Hq // Hkv, D, *_strides(q), *_strides(k),
            *_strides(v), float(scale), int(bool(causal)), int(window),
            float(cap), stream)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True,
                         window: int = 0, cap: float = 0.0):
    """Launch the forward on the current stream -> ``(o (B,S,Hq,D) in q's
    dtype, lse fp32 (B, Hkv, S*G))``.  Raises on inputs it does not take
    and on a failed launch."""
    _check(q, k, v)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hkv, S * (Hq // Hkv)), dtype=torch.float32,
                      device=q.device)
    lib = _lib(NAME, "flash_attention_fwd", _FWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        *_shape_args(q, k, v, scale, causal, window, cap, stream))
    build.check(lib, NAME, code)
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, scale: float,
                             causal: bool = True, window: int = 0,
                             cap: float = 0.0):
    """Launch the backward on the current stream -> ``(dq, dk, dv)`` in
    q's dtype, contiguous.  ``o``/``lse`` are the forward's outputs;
    ``do`` is made contiguous.  Raises on inputs it does not take and on a
    failed launch."""
    _check(q, k, v)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or not o.is_contiguous()):
        raise ValueError("flash_attention_bwd_cuda: o and do must be "
                         "(B,S,Hq,D) in q's dtype, o contiguous")
    if (lse.shape != (B, Hkv, S * (Hq // Hkv)) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_cuda: lse must be a contiguous "
                         "fp32 (B, Hkv, S*G) tensor")
    do = do.contiguous()
    dev = q.device
    delta = torch.empty_like(lse)
    dq_acc = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=dev)
    dk = torch.empty((B, T, Hkv, D), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    lib = _lib(BWD_NAME, "flash_attention_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.flash_attention_bwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_shape_args(q, k, v, scale, causal, window, cap, stream))
    build.check(lib, BWD_NAME, code)
    if q.dtype == torch.float32:
        return dq_acc, dk, dv
    dq = torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev)
    lib = _lib(BWD_NAME, "flash_attention_dq_convert", _CONVERT_ARGTYPES)
    code = lib.flash_attention_dq_convert(dq_acc.data_ptr(), dq.data_ptr(),
                                          dq.numel(), stream)
    build.check(lib, BWD_NAME, code)
    return dq, dk, dv
