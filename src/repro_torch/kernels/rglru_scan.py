"""RG-LRU linear recurrence on the card: the wrapper of ``csrc/rglru_scan.cu``.

``h_t = a_t * h_{t-1} + b_t`` per channel: a, b (B, S, W) fp32, read
through their strides; an optional h0 (B, W) fp32.  Returns h (B, S, W)
and h_last (B, W), fp32.  The kernel replaces the Pallas TPU kernel
``repro/kernels/rglru_scan.py::_rglru_kernel``; its plain version is
``kernels/ref.py::rglru_scan_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "rglru_scan"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_I] * 3 + [_L] * 6 + [_P]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if lib.rglru_scan.argtypes is None:
        lib.rglru_scan.argtypes = _ARGTYPES
        lib.rglru_scan.restype = ctypes.c_int
    return lib


def _check(a, b, h0) -> None:
    """Raise on any input the kernel does not take."""
    ts = [a, b] + ([h0] if h0 is not None else [])
    if not (a.is_cuda and all(t.device == a.device for t in ts)):
        raise ValueError("rglru_scan_cuda: a, b and h0 must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("rglru_scan_cuda: a, b and h0 must be float32")
    if a.dim() != 3 or b.shape != a.shape or min(a.shape) < 1:
        raise ValueError(f"rglru_scan_cuda: want a, b (B,S,W), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan_cuda: a and b need a contiguous last "
                         "dim")
    if h0 is not None and (h0.shape != (a.shape[0], a.shape[2])
                           or not h0.is_contiguous()):
        raise ValueError("rglru_scan_cuda: h0 must be a contiguous (B,W) "
                         "tensor")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0=None):
    """Launch the kernel on the current stream -> (h, h_last).  Raises on
    inputs it does not take and on a failed launch."""
    _check(a, b, h0)
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None,
        h.data_ptr(), h_last.data_ptr(), B, S, W, a.stride(0), a.stride(1),
        b.stride(0), b.stride(1), h.stride(0), h.stride(1), stream)
    build.check(lib, NAME, code)
    return h, h_last
