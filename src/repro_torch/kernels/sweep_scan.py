"""The sweep datapath's scan on the card: the wrapper of
``csrc/sweep_scan.cu``.

One launch runs ``S`` steps of the PsPIN event loop for every replica row
of a sweep (arrival or completion, the BVT/Jain fold, FMQ push, one WLBVT
or rr grant, the budget clamps) and writes the per-step records and the
final state.  The kernel replaces the JAX package's scan of the step
(``repro/sim/devicepath.py``, ``lax.scan`` inside ``jax.jit``) with its
Pallas WLBVT round ``repro/kernels/wlbvt_select.py::_select_kernel``
inlined; its plain version is ``kernels/ref.py::sweep_scan_ref``, which
it equals bit for bit in float32 and float64.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.configs.osmosis_pspin import PSPIN
from repro_torch.kernels import build
from repro_torch.kernels.ref import SWEEP_STATE

NAME = "sweep_scan"
MAX_TENANTS = 128     # tenant lanes (and PU slots) a row: four warps
MAX_PUS = 128
SCHEDULERS = ("wlbvt", "rr")
_DTYPES = {torch.float32: 0, torch.float64: 1}
# the kernel's pointer table, in its order (csrc/sweep_scan.cu)
INPUTS = ("arr_t", "arr_tenant", "arr_comp", "prio", "klim", "tlim",
          "fifo_cap", "ecn_m1", "n_arr", "horizon_live")
_I32 = {"fifo_cap", "ecn_m1", "n_arr", "queue_len", "cur_occup", "seq",
        "free_pus"}
_I64 = {"arr_tenant", "na", "rr_ptr", "fifo_head"}
_PER_TENANT = {"queue_len", "cur_occup", "total_occup", "bvt", "fifo_head",
               "spent"}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if lib.sweep_scan.argtypes is None:
        lib.sweep_scan.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_void_p]
        lib.sweep_scan.restype = ctypes.c_int
    return lib


def check_limits(T: int, P: int, scheduler: str) -> None:
    """The kernel's limits: one thread a tenant lane and a PU slot."""
    if not (1 <= T <= MAX_TENANTS and 1 <= P <= MAX_PUS):
        raise ValueError(
            f"sweep_scan supports 1..{MAX_TENANTS} tenants and 1..{MAX_PUS} "
            f"PUs (got T={T}, P={P})")
    if scheduler not in SCHEDULERS:
        raise ValueError(f"sweep_scan schedules {SCHEDULERS}, got "
                         f"{scheduler!r}")


def _dtype_of(name: str, fdt: torch.dtype) -> torch.dtype:
    if name in _I32:
        return torch.int32
    if name in _I64:
        return torch.int64
    return fdt


def _check(data: dict, T: int, P: int, C: int, S: int,
           scheduler: str) -> None:
    """Raise on any input the kernel does not take, before any launch."""
    check_limits(T, P, scheduler)
    if C < 1 or S < 0:
        raise ValueError(f"sweep_scan: want C >= 1 and S >= 0 (got C={C}, "
                         f"S={S})")
    missing = [n for n in INPUTS if n not in data]
    if missing:
        raise ValueError(f"sweep_scan: data lacks {missing}")
    ts = [data[n] for n in INPUTS]
    fdt = data["prio"].dtype
    if fdt not in _DTYPES:
        raise ValueError(f"sweep_scan_cuda: float inputs must be one of "
                         f"{list(_DTYPES)}, got {fdt}")
    for n, t in zip(INPUTS, ts):
        if t.dtype != _dtype_of(n, fdt):
            raise ValueError(f"sweep_scan_cuda: {n} is {t.dtype}, want "
                             f"{_dtype_of(n, fdt)}")
    R, NB1 = data["arr_t"].shape
    shapes = {"arr_t": (R, NB1), "arr_tenant": (R, NB1),
              "arr_comp": (R, NB1), "prio": (R, T), "klim": (R, T),
              "tlim": (R, T), "fifo_cap": (R, 1), "ecn_m1": (R, 1),
              "n_arr": (R,), "horizon_live": (R,)}
    for n, t in zip(INPUTS, ts):
        if tuple(t.shape) != shapes[n]:
            raise ValueError(f"sweep_scan_cuda: {n} has shape "
                             f"{tuple(t.shape)}, want {shapes[n]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("sweep_scan_cuda: inputs must be contiguous")
    if NB1 >= (1 << 30):      # slot meta packs pkt | kill<<30 | bk<<31
        raise ValueError(f"sweep_scan_cuda: {NB1} arrival columns; packet "
                         "ids must stay below 2^30")
    dev = data["arr_t"].device
    if not (dev.type == "cuda" and all(t.device == dev for t in ts)):
        raise ValueError("sweep_scan_cuda: every input must lie on one CUDA "
                         "device")


def sweep_scan_cuda(data: dict, *, T: int, P: int, C: int, S: int,
                    scheduler: str):
    """Launch the kernel on the current stream -> ``(state, ys)`` as
    ``ref.sweep_scan_ref`` returns them: the ``SWEEP_STATE`` fields and the
    records ``(eq_pack, t, comp_meta, comp_ktime)``, each ``[S, R]``.
    Raises on inputs it does not take and on a failed launch."""
    _check(data, T, P, C, S, scheduler)
    R, NB1 = data["arr_t"].shape
    dev = data["arr_t"].device
    fdt = data["prio"].dtype

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    ys = (empty((S, R), torch.int32), empty((S, R), fdt),
          empty((S, R), torch.int32), empty((S, R), fdt))
    state = {n: empty((R, T) if n in _PER_TENANT else (R,),
                      _dtype_of(n, fdt)) for n in SWEEP_STATE}
    # each tenant's FIFO ring: packet ids (< 2^30) and their cycles
    rings = (empty((R, T, C), torch.int32), empty((R, T, C), fdt))
    tensors = [data[n] for n in INPUTS] + list(ys) + \
        [state[n] for n in SWEEP_STATE] + list(rings)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    dims = (ctypes.c_longlong * 6)(R, T, P, C, S, NB1)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.sweep_scan(_DTYPES[fdt], int(scheduler == "wlbvt"), ptrs,
                          dims, PSPIN.cycles_ns(PSPIN.dma_setup_cycles),
                          PSPIN.ns_per_cycle, stream)
    build.check(lib, NAME, code)
    return state, ys
