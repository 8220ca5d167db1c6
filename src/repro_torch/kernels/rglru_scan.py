"""RG-LRU linear recurrence on the card: the wrapper of ``csrc/rglru_scan.cu``.

``h_t = a_t * h_{t-1} + b_t`` per channel: a, b (B, S, W) fp32, read
through their strides; an optional h0 (B, W) fp32.  Returns h (B, S, W)
and h_last (B, W), fp32.  The kernel replaces the Pallas TPU kernel
``repro/kernels/rglru_scan.py::_rglru_kernel``; its plain version is
``kernels/ref.py::rglru_scan_ref``, and ``ref.rglru_scan_segments_ref``
takes the kernel's order of operations at the segment lengths that
``geometry`` gives it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "rglru_scan"
WARPS = 8           # segments a block, one a warp
MAX_SEG = 16        # steps a segment: two buffers of its a and b in registers
MAX_CLUSTER = 8     # blocks a cluster (portable)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_I] * 3 + [_L] * 6 + [_I] * 2 + [_P]


def geometry(S: int) -> tuple:
    """(seg_len, cluster) of a sequence of S steps: each warp scans
    ``seg_len`` steps (the least power of two with ``WARPS * seg_len >=
    S``, at most ``MAX_SEG``), and ``cluster`` blocks (at most
    ``MAX_CLUSTER``) cover a tile of ``cluster * WARPS * seg_len`` steps;
    a longer sequence is walked tile by tile.  The one definition of the
    kernel's geometry: ``rglru_scan_cuda`` passes it to every launch, and
    the tests hold the segmented order at it."""
    seg = 1
    while seg < MAX_SEG and WARPS * seg < S:
        seg *= 2
    return seg, min(MAX_CLUSTER, -(-S // (WARPS * seg)))


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
    if a.dim() != 3 or b.shape != a.shape or min(a.shape) < 1 \
            or a.shape[0] > 65535:
        raise ValueError(f"rglru_scan_cuda: want a, b (B,S,W) with B <= "
                         f"65535, got {tuple(a.shape)}, {tuple(b.shape)}")
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
    seg_len, cluster = geometry(S)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None,
        h.data_ptr(), h_last.data_ptr(), B, S, W, a.stride(0), a.stride(1),
        b.stride(0), b.stride(1), h.stride(0), h.stride(1), seg_len, cluster,
        stream)
    build.check(lib, NAME, code)
    return h, h_last
