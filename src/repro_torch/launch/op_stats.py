"""Per-step op statistics of one rank's eager step: the counterpart of the
JAX package's ``launch/hlo_stats.py``.

PyTorch runs eagerly and has no HLO to walk, so ``analyze(fn, *args)``
runs the step itself under a ``TorchDispatchMode`` and counts every ATen
op it dispatches, with the reference's keys:

  * ``flops`` -- matmuls and convolutions by ``torch.utils.flop_counter``'s
    formulas (2 x M x N x K for a product; their part alone is
    ``matmul_flops``); 1 an output element for a
    pointwise op and 1 an input element for a reduction, as XLA's
    ``HloCostAnalysis`` counts them; a hand-written kernel's call on meta
    tensors (``kernels/ops.py``) by the work ``chip_smoke.py`` bounds it
    with.
  * ``bytes`` -- each op's tensor inputs plus its outputs (views and
    allocations without a write cost nothing).  Eager PyTorch does not
    fuse, so this is an upper bound beside XLA's fused proxy, which
    counts only a fusion's boundary.
  * per collective (``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``): operand bytes and
    ``<name>_count``, from the c10d and functional-collective ops the
    step dispatches (the port's collective call sites and DTensor's);
    ``collective_bytes`` their sum.
  * ``live_bytes`` -- the peak of the bytes of tensors the step created
    and still held (tracked per storage with ``weakref.finalize``), the
    counterpart of ``memory_analysis().temp_size_in_bytes``;
    ``output_bytes`` -- the step's returned tensors that it created.
  * ``kernels`` -- the hand-written kernels' calls by name.

On the meta device (the dry run) nothing is computed and nothing is
allocated: the numbers are one rank's, the step's shapes being its
shards'.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops as kops

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op name -> (kind, index of its operand argument)
_COLLECTIVE_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_out": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "all_to_all_single": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional")
# reductions: 1 flop an input element; softmax as its five passes
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "logsumexp", "prod", "cumsum", "any", "all",
               "norm", "var_mean"}
_SOFTMAX = {"_softmax", "_log_softmax"}
# ops that allocate or relabel without a write worth counting
_FREE = {"empty", "empty_like", "empty_strided", "detach", "alias",
         "lift_fresh", "set_", "resize_", "_unsafe_view"}
# indexed reads and writes touch the indexed elements, not the whole
# tensor they index (the JAX package's walker counts an in-place update
# by its update's bytes the same way)
_GATHERS = {"index", "gather"}
_SCATTERS = {"index_put_", "index_put", "_index_put_impl_", "scatter_",
             "scatter", "scatter_add_", "scatter_add", "index_add_",
             "index_copy_"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Stats(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.r: Dict[str, Any] = {"flops": 0.0, "matmul_flops": 0.0,
                                  "bytes": 0.0,
                                  **{c: 0.0 for c in COLLECTIVES},
                                  **{c + "_count": 0 for c in COLLECTIVES},
                                  "collective_bytes": 0.0}
        self.live = 0
        self.peak = 0
        self.held: Dict[int, list] = {}      # storage -> [bytes, holders]

    # -- live tensors ------------------------------------------------------
    def _release(self, key: int) -> None:
        ent = self.held.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self.held[key]

    def _hold(self, t: torch.Tensor, fresh: bool) -> None:
        key = _key(t)
        ent = self.held.get(key)
        if ent is None:
            if not fresh:
                return                       # an argument's storage
            ent = self.held[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                opd = _nbytes(_tensors(args[kind[1]]))
                self.r[kind[0]] += opd
                self.r[kind[0] + "_count"] += 1
                self.r["collective_bytes"] += opd
                self.r["bytes"] += opd + _nbytes(outs)
            return out
        mutable = func._schema.is_mutable
        for t in outs:
            self._hold(t, fresh=not (func.is_view or mutable))
        if func.is_view or name in _FREE:
            return out
        if name in _GATHERS:        # the gathered elements and the indices
            self.r["bytes"] += 2 * _nbytes(outs) + _nbytes(ins[1:])
        elif name in _SCATTERS:     # the updated region, read and written
            self.r["bytes"] += 3 * _nbytes(ins[1:])
        else:
            self.r["bytes"] += _nbytes(ins) + _nbytes(outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.r["flops"] += f
            self.r["matmul_flops"] += f
        elif torch.Tag.pointwise in func.tags:
            self.r["flops"] += sum(t.numel() for t in outs)
        elif name in _SOFTMAX:
            self.r["flops"] += 5 * ins[0].numel()
        elif name in _REDUCTIONS and ins:
            self.r["flops"] += ins[0].numel()
        return out


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and return its op statistics (see
    the module docstring)."""
    mode = _Stats()
    plan: Dict[str, float] = {}
    prev, kops.PLAN_COUNTER = kops.PLAN_COUNTER, plan
    try:
        with mode:
            out = fn(*args, **kwargs)
        keys = {_key(t) for t in _tensors(out)}
        out_bytes = sum(mode.held[k][0] for k in keys if k in mode.held)
    finally:
        kops.PLAN_COUNTER = prev
    r = mode.r
    r["flops"] += plan.pop("flops", 0.0)
    r["bytes"] += plan.pop("bytes", 0.0)
    r["kernels"] = plan
    r["live_bytes"] = mode.peak
    r["output_bytes"] = out_bytes
    return r
