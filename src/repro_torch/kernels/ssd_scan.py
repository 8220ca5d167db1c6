"""Mamba-2 SSD chunked scan on the card: the wrapper of ``csrc/ssd_scan.cu``.

In the model's layout: x (B, S, H, P) in bf16 or fp32, dt (B, S, H) fp32,
A_log (H,) fp32, B/C (B, S, G, N) in x's dtype or fp32 (head h reads
group h // (H/G)), all read through their strides; an optional initial state
(B, H, P, N) fp32.  Returns y (B, S, H, P) in x's dtype and the final
state (B, H, P, N) fp32.  The kernel replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::_ssd_kernel``; its plain version is
``kernels/ref.py::ssd_scan_ref``.  x, B and C in bf16 run on the tensor
cores (``ref.ssd_scan_bf16_ref`` is that kernel's order and rounding in
plain torch); fp32 x, or fp32 B/C, run the exact scalar kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 7 + [_L] * 15 + [_P]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.argtypes = _ARGTYPES
        lib.ssd_scan.restype = ctypes.c_int
    return lib


def _check(x, dt, A_log, B_mat, C_mat, init_state, chunk) -> None:
    """Raise on any input the kernel does not take."""
    ts = [x, dt, A_log, B_mat, C_mat] + (
        [init_state] if init_state is not None else [])
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("ssd_scan_cuda: every input must lie on one CUDA "
                         "device")
    if x.dtype not in _DTYPES or C_mat.dtype != B_mat.dtype \
            or B_mat.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"ssd_scan_cuda: x must be one of {list(_DTYPES)} "
                         f"and B/C alike, of x's dtype or float32, got "
                         f"{x.dtype}, {B_mat.dtype}, {C_mat.dtype}")
    if dt.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise ValueError("ssd_scan_cuda: dt and A_log must be float32")
    if x.dim() != 4 or B_mat.dim() != 4 or C_mat.shape != B_mat.shape:
        raise ValueError(f"ssd_scan_cuda: want x (B,S,H,P) and B/C "
                         f"(B,S,G,N), got {tuple(x.shape)}, "
                         f"{tuple(B_mat.shape)}, {tuple(C_mat.shape)}")
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if dt.shape != (Bb, S, H) or A_log.shape != (H,) \
            or B_mat.shape[:2] != (Bb, S) or H % G:
        raise ValueError("ssd_scan_cuda: x, dt, A_log and B/C shapes "
                         "disagree")
    if min(x.shape) < 1 or P > MAX_HEAD_DIM or N < 1 or N > MAX_STATE:
        raise ValueError(f"ssd_scan_cuda: head dim at most {MAX_HEAD_DIM}, "
                         f"state dim at most {MAX_STATE}, no empty input")
    if chunk < 1:
        raise ValueError("ssd_scan_cuda: chunk must be positive")
    if min(chunk, S) > MAX_CHUNK:
        raise ValueError(f"ssd_scan_cuda: chunk at most {MAX_CHUNK}")
    for name, t in (("x", x), ("B", B_mat), ("C", C_mat)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan_cuda: {name} needs a contiguous "
                             "last dim")
    if not A_log.is_contiguous():
        raise ValueError("ssd_scan_cuda: A_log must be contiguous")
    if init_state is not None and (
            init_state.dtype != torch.float32
            or init_state.shape != (Bb, H, P, N)
            or not init_state.is_contiguous()):
        raise ValueError("ssd_scan_cuda: init_state must be a contiguous "
                         "float32 (B,H,P,N) tensor")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  B_mat: torch.Tensor, C_mat: torch.Tensor, *,
                  chunk: int, init_state=None):
    """Launch the kernel on the current stream -> (y, final_state).
    Raises on inputs it does not take and on a failed launch."""
    _check(x, dt, A_log, B_mat, C_mat, init_state, chunk)
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.ssd_scan(
        _DTYPES[x.dtype], _DTYPES[B_mat.dtype], x.data_ptr(), dt.data_ptr(),
        A_log.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), final.data_ptr(), Bb, S, H, G, P, N, min(chunk, S),
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        dt.stride(2), B_mat.stride(0), B_mat.stride(1), B_mat.stride(2),
        C_mat.stride(0), C_mat.stride(1), C_mat.stride(2), y.stride(0),
        y.stride(1), y.stride(2), stream)
    build.check(lib, NAME, code)
    return y, final
