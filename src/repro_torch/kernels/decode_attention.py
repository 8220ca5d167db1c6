"""Decode attention on the card: the wrapper of ``csrc/decode_attention.cu``.

One query token per batch row against that row's KV cache, in the
model's layout: q (B, 1, Hq, D), k/v (B, T, Hkv, D) read through their
strides, lengths (B,) int32, and optionally each key's stored position
(B, T) int32 for a ring cache.  The kernel replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::_decode_kernel``; its plain version
is ``kernels/ref.py::decode_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "decode_attention"
MAX_GROUPS = 16       # query heads per KV head
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _F, _P, _L, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if lib.decode_attention.argtypes is None:
        lib.decode_attention.argtypes = _ARGTYPES
        lib.decode_attention.restype = ctypes.c_int
    return lib


def _check(q, k, v, lengths, positions) -> None:
    """Raise on any input the kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and lengths.device == q.device):
        raise ValueError("decode_attention_cuda: q, k, v and lengths must "
                         "lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention_cuda: q/k/v must share one "
                         f"dtype of {list(_DTYPES)}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention_cuda: want q (B,1,Hq,D) and "
                         f"k/v (B,T,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError("decode_attention_cuda: q and k/v shapes disagree")
    if Hq // k.shape[2] > MAX_GROUPS or D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention_cuda: at most {MAX_GROUPS} query "
                         f"heads per KV head and head dim {MAX_HEAD_DIM}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("decode_attention_cuda: lengths must be a "
                         "contiguous int32 (B,) tensor")
    vec = 16 // q.element_size()        # the kernel's 16-byte loads
    for name, t in (("k", k), ("v", v)):
        if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1])
                or t.data_ptr() % 16 or D % vec):
            raise ValueError(f"decode_attention_cuda: {name} needs a "
                             f"contiguous last dim, strides that are "
                             f"multiples of {vec} elements, 16-byte "
                             f"alignment and D % {vec} == 0")
    if q.stride(-1) != 1:
        raise ValueError("decode_attention_cuda: q needs a contiguous "
                         "last dim")
    if positions is not None and (
            positions.device != q.device or positions.dtype != torch.int32
            or positions.shape != (B, k.shape[1])
            or positions.stride(-1) != 1):
        raise ValueError("decode_attention_cuda: positions must be an int32 "
                         "(B,T) tensor on q's device with a contiguous last "
                         "dim")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, scale: float,
                          window: int = 0, cap: float = 0.0,
                          positions=None) -> torch.Tensor:
    """Launch the kernel on the current stream -> (B, 1, Hq, D) in q's
    dtype.  Raises on inputs it does not take and on a failed launch."""
    _check(q, k, v, lengths, positions)
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, T, Hkv, Hq // Hkv, D,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(2),
        float(scale), int(window), float(cap),
        positions.data_ptr() if positions is not None else None,
        positions.stride(0) if positions is not None else 0, stream)
    build.check(lib, NAME, code)
    return out
