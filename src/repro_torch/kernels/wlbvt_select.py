"""WLBVT dispatch round on the card: the wrapper of ``csrc/wlbvt_select.cu``.

One round grants up to ``free_k[r]`` PU slots in each replica row: every
pick recomputes eligibility (queue non-empty, occupancy under the
weighted ``pu_limit`` cap) and takes the eligible tenant with the lowest
priority-normalized throughput.  The kernel replaces the Pallas TPU
kernel ``repro/kernels/wlbvt_select.py::_select_kernel``; its plain
version is ``kernels/ref.py::wlbvt_select_rounds_ref``, which it equals
bit for bit in float32 and float64.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "wlbvt_select"
MAX_TENANTS = 128     # tenant lanes per row: four warps
MAX_PICKS = 128
_DTYPES = {torch.float32: 0, torch.float64: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if lib.wlbvt_select.argtypes is None:
        lib.wlbvt_select.argtypes = _ARGTYPES
        lib.wlbvt_select.restype = ctypes.c_int
    return lib


def check_limits(T: int, max_picks: int) -> None:
    """The kernel's limits (those of the Pallas kernel it replaces)."""
    if T > MAX_TENANTS or max_picks > MAX_PICKS:
        raise ValueError(
            f"wlbvt_select supports T <= {MAX_TENANTS} tenants and "
            f"max_picks <= {MAX_PICKS} (got T={T}, max_picks={max_picks})")


def _check(prio, queue_len, cur_occup, total_occup, bvt, free_k,
           max_picks: int) -> None:
    """Raise on any input the kernel does not take."""
    ts = (prio, queue_len, cur_occup, total_occup, bvt, free_k)
    if not (prio.is_cuda and all(t.device == prio.device for t in ts)):
        raise ValueError("wlbvt_select_cuda: every input must lie on one "
                         "CUDA device")
    if prio.dim() != 2:
        raise ValueError(f"wlbvt_select_cuda: want [R, T] inputs, got "
                         f"{tuple(prio.shape)}")
    R, T = prio.shape
    check_limits(T, max_picks)
    if prio.dtype not in _DTYPES or total_occup.dtype != prio.dtype \
            or bvt.dtype != prio.dtype:
        raise ValueError(f"wlbvt_select_cuda: prio/total_occup/bvt must "
                         f"share one dtype of {list(_DTYPES)}, got "
                         f"{prio.dtype}, {total_occup.dtype}, {bvt.dtype}")
    if any(t.dtype != torch.int32 for t in (queue_len, cur_occup, free_k)):
        raise ValueError("wlbvt_select_cuda: queue_len/cur_occup/free_k "
                         "must be int32")
    if any(t.shape != (R, T) for t in ts[1:5]) or free_k.shape != (R,):
        raise ValueError("wlbvt_select_cuda: want [R, T] lanes and free_k "
                         "[R]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("wlbvt_select_cuda: inputs must be contiguous")


def wlbvt_select_cuda(prio, queue_len, cur_occup, total_occup, bvt, free_k,
                      *, num_pus: int, max_picks: int):
    """Launch the kernel on the current stream -> ``(picks [R, max_picks]
    int32, queue_len', cur_occup')``.  Raises on inputs it does not take
    and on a failed launch."""
    _check(prio, queue_len, cur_occup, total_occup, bvt, free_k, max_picks)
    R, T = prio.shape
    dev = prio.device
    picks = torch.empty((R, max_picks), dtype=torch.int32, device=dev)
    ql_out = torch.empty((R, T), dtype=torch.int32, device=dev)
    co_out = torch.empty((R, T), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.wlbvt_select(
        _DTYPES[prio.dtype], prio.data_ptr(), queue_len.data_ptr(),
        cur_occup.data_ptr(), total_occup.data_ptr(), bvt.data_ptr(),
        free_k.data_ptr(), picks.data_ptr(), ql_out.data_ptr(),
        co_out.data_ptr(), R, T, int(num_pus), int(max_picks), stream)
    build.check(lib, NAME, code)
    return picks, ql_out, co_out
