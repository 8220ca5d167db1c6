"""Backend-generic WLBVT / DWRR scheduling kernels.

Single source of truth for the paper's two arbitration policies: every
function here is written once against an array namespace ``xp``, is
purely functional (returns new arrays, never mutates), and is
branch-free in array values.  The serving engine calls it on fp64 numpy
arrays through the stateful wrappers in ``core/wlbvt.py``
(``WLBVTState``/``DWRRState``); the tensor twins in the same module
(``select_torch``, ``dwrr_select_torch``, ...) call the scalar functions
on torch tensors, and the sweep datapath calls the lane functions
(``tput``, ``pu_limit_lanes``, ``select_lanes``, ``select_rr``) on
``[R, T]`` torch tensors, both through ``torch_namespace``, so each
formula exists once.

The only Python-level branches are on *static* configuration (``cap is
None``/``mask is None``).
"""
from __future__ import annotations

import functools

import torch

BIG = 1e30        # ineligible-metric sentinel (select)
CEIL_EPS = 1e-6   # pre-ceil epsilon: fp32 (hw-width) and fp64 (reference)
#                   pu_limit agree at exact-integer boundaries
GRANT_EPS = 1e-9  # DWRR deficit comparison slack


# ---------------------------------------------------------------------------
# WLBVT (PU scheduling — paper Listing 1, §5.3)
# ---------------------------------------------------------------------------
def tput(total_occup, bvt, xp):
    """Priority-unnormalized service rate (paper line 12)."""
    return total_occup / xp.maximum(bvt, 1.0)


def advance(queue_len, cur_occup, total_occup, bvt, dt, xp):
    """Fold ``dt`` cycles of update_tput (paper lines 8-13) in one step.

    Returns the new ``(total_occup, bvt)``; inactive tenants' virtual
    time stays frozen so an idle tenant does not bank credit.
    """
    act = (queue_len > 0) | (cur_occup > 0)
    total_occup = total_occup + xp.where(act, cur_occup * dt, 0.0)
    bvt = bvt + xp.where(act, dt, 0.0)
    return total_occup, bvt


def pu_limit(prio, queue_len, num_pus, xp):
    """Weighted per-tenant PU cap as a float array of integral values.

    Listing 1 lines 4-5: prio_sum over *non-empty* FMQs — queues that
    drained release their share immediately (work conservation).  See
    DESIGN.md §3.2 for the ``num_pus``-vs-``len(FMQs)`` interpretation
    note and the CEIL_EPS rationale.
    """
    nonempty = queue_len > 0
    psum = xp.sum(xp.where(nonempty, prio, 0.0))
    lim = xp.ceil(num_pus * prio / xp.maximum(psum, 1e-9) - CEIL_EPS)
    return xp.where(psum > 0, lim, float(num_pus))


def select(prio, queue_len, cur_occup, total_occup, bvt, num_pus, xp,
           cap=None):
    """One WLBVT decision (paper lines 15-24): the non-empty FMQ under its
    weighted PU cap with the lowest priority-normalized throughput.

    ``cap`` (optional int array) is an extra per-tenant occupancy ceiling
    folded into eligibility — the serving engine passes its static
    KV-quota slot caps here (R3).  Returns -1 if nothing is eligible.
    """
    limit = pu_limit(prio, queue_len, num_pus, xp)
    eligible = (queue_len > 0) & (cur_occup < limit)
    if cap is not None:
        eligible = eligible & (cur_occup < cap)
    metric = xp.where(eligible, tput(total_occup, bvt, xp) / prio, BIG)
    idx = xp.argmin(metric)
    return xp.where(xp.any(eligible), idx, -1)


def select_round(prio, queue_len, cur_occup, total_occup, bvt, num_pus, xp,
                 cap=None):
    """One pick of a multi-winner round: returns ``(idx, queue_len,
    cur_occup)`` with the winner's queue drained by one and its occupancy
    charged — exactly the state transition the sequential scalar loop
    performed between two ``select`` calls.  ``select_k`` callers iterate
    this kernel in a Python loop."""
    idx = select(prio, queue_len, cur_occup, total_occup, bvt, num_pus, xp,
                 cap=cap)
    won = idx >= 0
    iv = xp.where(won, idx, 0)
    hot = (xp.arange(queue_len.shape[0]) == iv) & won
    queue_len = queue_len - hot.astype(queue_len.dtype)
    cur_occup = cur_occup + hot.astype(cur_occup.dtype)
    return idx, queue_len, cur_occup


def select_rr(ptr, queue_len, xp, mask=None):
    """Vectorized round-robin baseline (paper Fig. 4/9): first non-empty
    queue at or after ``ptr``.  Returns ``(idx, new_ptr)``; the pointer
    is unchanged when nothing is pending.  Lanes are the trailing axis:
    ``queue_len [..., T]`` with ``ptr [...]`` is one pick per leading
    index (a scalar ``ptr`` and a ``[T]`` queue is the single pick)."""
    T = queue_len.shape[-1]
    ok = queue_len > 0
    if mask is not None:
        ok = ok & mask
    order = (xp.arange(T) - xp.asarray(ptr)[..., None]) % T
    i = xp.argmin(xp.where(ok, order, T), axis=-1)
    found = xp.any(ok, axis=-1)
    idx = xp.where(found, i, -1)
    new_ptr = xp.where(found, (i + 1) % T, ptr)
    return idx, new_ptr


# ---------------------------------------------------------------------------
# DWRR (IO arbitration — paper §5.1 step 5, §6.2)
# ---------------------------------------------------------------------------
def dwrr_grant(deficit, ptr, head, pending, xp):
    """Spend phase: first pending queue (in RR order from ``ptr``) whose
    deficit covers its head fragment.  Returns ``(idx, deficit, ptr)``;
    idx -1 and unchanged state when no queue can be granted."""
    Q = deficit.shape[0]
    ok = pending & (deficit >= head - GRANT_EPS)
    order = (xp.arange(Q) - ptr) % Q
    i = xp.argmin(xp.where(ok, order, Q))
    found = xp.any(ok)
    charge = xp.where((xp.arange(Q) == i) & found, head, 0.0)
    idx = xp.where(found, i, -1)
    new_ptr = xp.where(found, (i + 1) % Q, ptr)
    return idx, deficit - charge, new_ptr


def dwrr_select(weights, deficit, ptr, head, pending, quantum, xp):
    """One DWRR grant with O(1) virtual-time top-up.

    Spend existing credit first; if no pending queue is covered, jump
    directly to the first round at which *some* pending queue becomes
    eligible (equivalent to iterating rounds, robust to heads many quanta
    large) and grant from the saved pointer.  Idle queues cannot hoard
    more than one head+quantum of credit.  Returns ``(idx, deficit,
    ptr)``; idx -1 and unchanged state when nothing is pending.
    """
    any_p = xp.any(pending)
    i1, d1, p1 = dwrr_grant(deficit, ptr, head, pending, xp)
    f1 = i1 >= 0
    inc = quantum * weights
    need = xp.maximum(xp.where(pending, head - deficit, 0.0), 0.0)
    rounds_each = xp.where(pending,
                           xp.ceil(need / xp.maximum(inc, 1e-30)), BIG)
    rounds = xp.maximum(xp.min(rounds_each), 1.0)
    topped = xp.minimum(deficit + xp.where(pending, rounds * inc, 0.0),
                        head + inc)  # idle-credit cap, applied to all queues
    i2, d2, p2 = dwrr_grant(topped, ptr, head, pending, xp)
    idx = xp.where(any_p, xp.where(f1, i1, i2), -1)
    new_deficit = xp.where(any_p, xp.where(f1, d1, d2), deficit)
    new_ptr = xp.where(any_p, xp.where(f1, p1, p2), ptr)
    return idx, new_deficit, new_ptr


# ---------------------------------------------------------------------------
# Lane-batched WLBVT (device datapath — DESIGN.md §13)
# ---------------------------------------------------------------------------
def pu_limit_lanes(prio, queue_len, num_pus, xp):
    """`pu_limit` reduced over the trailing tenant axis: every leading
    axis is an independent replica lane, so one call computes the caps
    for a whole ``[R, T]`` sweep batch.  Formula is token-for-token the
    scalar kernel's — the device datapath's parity guarantee rests on
    the two never diverging."""
    nonempty = queue_len > 0
    psum = xp.sum(xp.where(nonempty, prio, 0.0), axis=-1, keepdims=True)
    lim = xp.ceil(num_pus * prio / xp.maximum(psum, 1e-9) - CEIL_EPS)
    return xp.where(psum > 0, lim, float(num_pus))


def select_lanes(prio, queue_len, cur_occup, total_occup, bvt, num_pus, xp,
                 metric=None):
    """`select` over ``[..., T]`` lanes: one WLBVT decision per leading
    index, -1 where nothing is eligible.  ``metric`` lets round callers
    hoist the throughput term (constant within a dispatch round — picks
    change only eligibility, never total_occup/bvt/prio)."""
    limit = pu_limit_lanes(prio, queue_len, num_pus, xp)
    eligible = (queue_len > 0) & (cur_occup < limit)
    if metric is None:
        metric = tput(total_occup, bvt, xp) / prio
    masked = xp.where(eligible, metric, BIG)
    idx = xp.argmin(masked, axis=-1)
    any_e = xp.any(eligible, axis=-1)
    return xp.where(any_e, idx, -1)


# ---------------------------------------------------------------------------
# torch namespace (sweep datapath)
# ---------------------------------------------------------------------------
def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing (tenant) axis in one fixed order, the order
    of the CUDA kernels' ``lane_sum`` (``kernels/csrc/wlbvt_round.cuh``,
    run by ``wlbvt_select`` and ``sweep_scan``): lanes in warps of 32, zero
    padded; each warp summed by a halving tree (lane i + lane i+16, then
    +8, +4, +2, +1); the warps' sums added left to right.  Zero lanes
    add exactly, so the tree over the next power of two >= T gives the
    same bits as over 32.  The same order on every device makes the
    kernel, its plain version and a CPU run agree bit for bit."""
    T = x.shape[-1]
    width = 32 if T > 32 else 1 << max(T - 1, 0).bit_length()
    nw = -(-T // width)
    if nw * width != T:
        x = torch.nn.functional.pad(x, (0, nw * width - T))
    x = x.reshape(*x.shape[:-1], nw, width)
    off = width // 2
    while off:
        x = x[..., :off] + x[..., off:2 * off]
        off //= 2
    s = x[..., 0, 0]
    for w in range(1, nw):
        s = s + x[..., w, 0]
    return s


class _TorchNamespace:
    """The numpy calls of the formulas above, on torch tensors of one
    device.  Python scalars stay weakly typed (``maximum(t, 1.0)`` keeps
    ``t``'s dtype; ``where`` takes a scalar as a cached 0-dim tensor of
    the other operand's dtype, the same rounding); sums over the lane
    axis take ``lane_sum``'s order."""

    def __init__(self, device: torch.device):
        self.device = device
        self._consts = {}

    def _cached(self, key, make):
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = make()
        return c

    def _const(self, v, dtype):
        return self._cached((v, dtype), lambda: torch.tensor(
            v, dtype=dtype, device=self.device))

    def asarray(self, x):
        return torch.as_tensor(x, device=self.device)

    def arange(self, n: int):
        """``arange(n)``, cached: the formulas only read it."""
        return self._cached(("arange", n), lambda: torch.arange(
            n, device=self.device))

    @staticmethod
    def maximum(a, b):
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp(a, min=b)

    def where(self, cond, a, b):
        if not isinstance(a, torch.Tensor):
            a = self._const(a, b.dtype)
        elif not isinstance(b, torch.Tensor):
            b = self._const(b, a.dtype)
        return torch.where(cond, a, b)

    @staticmethod
    def minimum(a, b):
        if isinstance(b, torch.Tensor):
            return torch.minimum(a, b)
        return torch.clamp(a, max=b)

    @staticmethod
    def min(x):
        return x.min()

    @staticmethod
    def ceil(x):
        return torch.ceil(x)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        if axis is None:
            return x.sum()
        if axis not in (-1, x.dim() - 1):
            raise ValueError("the torch namespace sums over the lane axis")
        s = lane_sum(x)
        return s[..., None] if keepdims else s

    @staticmethod
    def argmin(x, axis=None):
        return torch.argmin(x, dim=axis)

    @staticmethod
    def any(x, axis=None):
        return x.any() if axis is None else x.any(dim=axis)


@functools.lru_cache(maxsize=None)
def torch_namespace(device) -> _TorchNamespace:
    """The ``xp`` that runs this module's lane functions on ``device``."""
    return _TorchNamespace(torch.device(device))
