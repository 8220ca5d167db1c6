"""Public entry points of the port's kernels, in model layout.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
PyTorch version (``kernels/ref.py``); a CUDA tensor launches the
hand-written kernel, which raises on anything it does not take.  Nothing
falls back from the kernel to the plain version.  A meta tensor (the dry
run, ``launch/dryrun.py``) computes nothing: the call returns empty
outputs of the kernel's shapes and adds the kernel's work to
``PLAN_COUNTER`` when one is set.  Any other device raises.

``LAUNCHES`` counts kernel launches per kernel name (plain ints): the
main path's launches are read from it after a run that set it to zero.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.kernels.sweep_scan import check_limits as sweep_limits
from repro_torch.kernels.sweep_scan import sweep_scan_cuda
from repro_torch.kernels.wlbvt_select import check_limits, wlbvt_select_cuda

LAUNCHES: Dict[str, int] = {"decode_attention": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "wlbvt_select": 0,
                            "ssd_scan": 0, "rglru_scan": 0, "sweep_scan": 0}
WLBVT_IMPLS = ("", "jnp", "jnp_ref", "pallas")

# The dry run's tally of kernel work on meta tensors: {"flops", "bytes",
# "<kernel>": calls}, or None (``launch/op_stats.py`` sets it for a trace).
# The work is what ``chip_smoke.py`` bounds each kernel by: every input
# read once, every output written once, the products of a full cache.
PLAN_COUNTER: Optional[Dict[str, float]] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _plan(name: str, flops: float, nbytes: float) -> None:
    if PLAN_COUNTER is not None:
        PLAN_COUNTER["flops"] = PLAN_COUNTER.get("flops", 0.0) + flops
        PLAN_COUNTER["bytes"] = PLAN_COUNTER.get("bytes", 0.0) + nbytes
        PLAN_COUNTER[name] = PLAN_COUNTER.get(name, 0) + 1


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def decode_attention(q, k, v, lengths, *, scale: float, window: int = 0,
                     cap: float = 0.0, positions=None,
                     return_lse: bool = False):
    """q: (B,1,Hq,D); k/v: (B,T,Hkv,D); lengths: (B,) -> (B,1,Hq,D).

    Keys at positions ``0 <= kpos < lengths[b]`` (and within ``window`` of
    the length) count; a key's position is its index, or
    ``positions[b, t]`` (B,T) when given (a ring cache).  Rows with a
    length <= 0 return 0.  ``return_lse``: also each head's log-sum-exp
    of its counted scores, (B, Hq) fp32 (NEG_INF where none counts); on a
    CUDA tensor the kernel writes it."""
    kw = dict(scale=scale, window=window, cap=cap, positions=positions)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths,
                                        return_lse=return_lse, **kw)
    if q.device.type == "meta":
        B, _, Hq, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        live = T if positions is not None or window <= 0 else min(T, window)
        out = torch.empty_like(q)
        lse = (torch.empty((B, Hq), dtype=torch.float32, device=q.device)
               if return_lse else None)
        kv = 2 * B * live * Hkv * D * k.element_size()
        _plan("decode_attention", 4 * B * Hq * live * D,
              kv + _nbytes(q, out, lengths, positions, lse))
        return (out, lse) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    out = decode_attention_cuda(q, k, v, lengths.to(torch.int32),
                                return_lse=return_lse, **kw)
    LAUNCHES["decode_attention"] += 1
    return out


def _no_grad(name: str, *ts) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name}: the kernel has no backward kernel yet, so it takes no "
            "input that requires grad; train this block under "
            "attn_impl='chunked'")


def ssd_scan(x, dt, A_log, B_mat, C_mat, *, chunk: int = 128,
             init_state=None):
    """Mamba-2 SSD scan in model layout: x (B,S,H,P); dt (B,S,H); A_log
    (H,); B/C (B,S,G,N); init_state (B,H,P,N) or None (zero) -> (y
    (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).  Contract:
    ``kernels/ref.py::ssd_scan_ref``; the kernel works in chunks of
    ``min(chunk, S)`` rows.  Forward only: raises if an input requires
    grad."""
    _no_grad("ssd_scan", x, dt, A_log, B_mat, C_mat, init_state)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A_log, B_mat, C_mat,
                                init_state=init_state)
    if x.device.type == "meta":
        return _ssd_meta(x, dt, A_log, B_mat, C_mat, chunk, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    out = ssd_scan_cuda(x, dt.float(), A_log.float(), B_mat, C_mat,
                        chunk=chunk, init_state=init_state)
    LAUNCHES["ssd_scan"] += 1
    return out


def rglru_scan(a, b, h0=None):
    """``h_t = a_t h_{t-1} + b_t`` per channel from h0 (zero when None):
    a, b (B,S,W) -> (h (B,S,W), h_last (B,W)), fp32.  Contract:
    ``kernels/ref.py::rglru_scan_ref``.  Forward only: raises if an input
    requires grad."""
    _no_grad("rglru_scan", a, b, h0)
    a, b = a.float(), b.float()
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    if a.device.type == "meta":
        h, last = torch.empty_like(a), torch.empty_like(a[:, 0])
        _plan("rglru_scan", 2 * a.numel(), _nbytes(a, b, h0, h, last))
        return h, last
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    out = rglru_scan_cuda(a, b, h0)
    LAUNCHES["rglru_scan"] += 1
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
        elif dev == "meta":
            o, lse = _flash_meta(q, k, v, kw, backward=False)
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
        elif q.device.type == "meta":
            dq, dk, dv = _flash_meta(q, k, v, ctx.kw, backward=True)
        else:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                  **ctx.kw)
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None, None


def _flash_meta(q, k, v, kw, *, backward: bool):
    """The flash pair's outputs on the meta device, and their work: per
    (query, key) pair that the mask keeps, 4 D flops forward and 10 D
    backward."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    win = kw["window"]
    if kw["causal"]:
        per_head = sum(min(s + 1, win or T) for s in range(min(S, T)))
    else:
        per_head = S * T
    pairs = B * Hq * per_head
    lse_bytes = B * Hq * S * 4
    if backward:
        grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        _plan("flash_attention_bwd", 10 * D * pairs,
              2 * _nbytes(q) + _nbytes(q, k, v) + lse_bytes
              + _nbytes(*grads))
        return grads
    o = torch.empty_like(q)
    lse = torch.empty((B, Hkv, S * (Hq // Hkv)), dtype=torch.float32,
                      device=q.device)
    _plan("flash_attention", 4 * D * pairs, _nbytes(q, k, v, o) + lse_bytes)
    return o, lse


def _ssd_meta(x, dt, A_log, B_mat, C_mat, chunk: int, init_state):
    """The SSD scan's outputs on the meta device, and its work (the
    chunked scan's products, as ``chip_smoke.ssd_cost`` counts them)."""
    B, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    Q = min(chunk, S)
    flops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        flops += 2 * (q * (q + 1) // 2) * (N + P) + 2 * q * P * N
        if init_state is not None or c0 > 0:
            flops += 2 * q * P * N
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    _plan("ssd_scan", flops * B * H,
          _nbytes(x, dt, A_log, B_mat, C_mat, init_state, y, state))
    return y, state


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


def sweep_scan(data: dict, *, T: int, P: int, C: int, S: int,
               scheduler: str, impl: str = ""):
    """``S`` steps of the sweep datapath's event loop over every replica
    row of ``data`` (``sim/devicepath.scan_inputs``), from the empty state
    -> ``(state, ys)`` (contract: ``kernels/ref.py::sweep_scan_ref``).

    ``impl`` is the WLBVT round's (``wlbvt_select_rounds``): on a CUDA
    tensor ``""`` and ``"pallas"`` launch the kernel, in which the round
    is inlined, and the plain impls raise; on a CPU tensor every impl runs
    the plain version."""
    if impl not in WLBVT_IMPLS:
        raise ValueError(f"unknown wlbvt_select impl {impl!r} "
                         "(expected jnp | jnp_ref | pallas)")
    if impl == "pallas":      # the kernel's limits, on every device
        sweep_limits(T, P, scheduler)
    dev = data["arr_t"].device.type
    kw = dict(T=T, P=P, C=C, S=S, scheduler=scheduler)
    if dev == "cpu":
        return ref.sweep_scan_ref(data, **kw)
    if dev != "cuda":
        raise ValueError(f"sweep_scan: no kernel for device "
                         f"{data['arr_t'].device}")
    if impl not in ("", "pallas"):
        raise ValueError(f"wlbvt_select impl {impl!r} is a plain version, "
                         "for CPU tensors; on a CUDA tensor only the kernel "
                         "runs (impl '' or 'pallas')")
    out = sweep_scan_cuda(data, **kw)
    LAUNCHES["sweep_scan"] += 1
    return out
