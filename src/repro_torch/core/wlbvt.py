"""WLBVT / RR / WRR schedulers — paper Listing 1 and §5.3.

The stateful numpy surface of the backend-generic core
(``core/sched_generic.py``): ``WLBVTState``/``DWRRState`` +
``select``/``select_k``/``advance``/``pu_limit``/``dwrr_select``, as the
simulators' and the serving engine's host control planes call them
(event-driven, so per-cycle ``update_tput`` is folded into
``advance(dt)``).  The ``*_torch`` functions are the same formulas on
float32/int32 tensors of one device (the JAX package's ``*_jnp``
surface): functional, a dict of tensors for the state.

``select_k(st, num_pus, k)`` is the batch API: the k winners of one
scheduling round in a single call.

Interpretation note (DESIGN.md §3.2): Listing 1's
``pu_limit = ceil(len(FMQs) * prio / prio_sum)`` reads as the *PU count*
times the normalized priority — with ``len(FMQs)`` the paper's 128-FMQ
constant the limit would never bind at 32 PUs, contradicting §5.3's
"weighted PU occupation's upper limit guarantees fair QoS".  We use
``ceil(num_pus * prio / prio_sum_active)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sched_generic as G
from repro_torch.core.sched_generic import BIG, CEIL_EPS, GRANT_EPS  # noqa: F401


# ---------------------------------------------------------------------------
# numpy surface (simulator control plane)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WLBVTState:
    prio: np.ndarray            # (T,) float64, >0
    total_occup: np.ndarray     # (T,) float64 — cumulative PU-cycles
    bvt: np.ndarray             # (T,) float64 — active cycles
    cur_occup: np.ndarray       # (T,) int64 — PUs currently held
    queue_len: np.ndarray       # (T,) int64 — packets waiting

    @classmethod
    def create(cls, priorities) -> "WLBVTState":
        p = np.asarray(priorities, np.float64)
        T = p.shape[0]
        return cls(prio=p.copy(),
                   total_occup=np.zeros(T), bvt=np.zeros(T),
                   cur_occup=np.zeros(T, np.int64),
                   queue_len=np.zeros(T, np.int64))

    @property
    def active(self) -> np.ndarray:
        return (self.queue_len > 0) | (self.cur_occup > 0)

    def tput(self) -> np.ndarray:
        return G.tput(self.total_occup, self.bvt, np)


def advance(st: WLBVTState, dt: float) -> None:
    """Fold `dt` cycles of update_tput (paper lines 8-13) in one step."""
    st.total_occup, st.bvt = G.advance(
        st.queue_len, st.cur_occup, st.total_occup, st.bvt, float(dt), np)


def pu_limit(st: WLBVTState, num_pus: int) -> np.ndarray:
    return G.pu_limit(st.prio, st.queue_len, num_pus, np).astype(np.int64)


def select(st: WLBVTState, num_pus: int, cap=None) -> int:
    """Paper lines 15-24: non-empty FMQ under its weighted PU cap with the
    lowest priority-normalized throughput.  Returns -1 if none eligible.
    ``cap`` optionally folds an extra occupancy ceiling (e.g. KV-quota
    slot caps) into eligibility."""
    return int(G.select(st.prio, st.queue_len, st.cur_occup,
                        st.total_occup, st.bvt, num_pus, np, cap=cap))


def select_k(st: WLBVTState, num_pus: int, k: int, cap=None) -> np.ndarray:
    """Batch API: the k winners of one scheduling round.

    Equivalent to k sequential ``select`` calls with the winner's queue
    popped and occupancy charged between picks — ``st.queue_len`` and
    ``st.cur_occup`` are updated in place accordingly (the caller then
    dequeues the actual work items in pick order).  Returns a (k,) int64
    array, -1-padded once nothing is eligible.
    """
    picks = np.full(k, -1, np.int64)
    # Round invariants, hoisted: total_occup/bvt (hence the metric) never
    # change between picks, and pu_limit only changes when a pick drains
    # a queue to zero (the non-empty prio_sum shrinks — work conservation).
    # Between drains each pick only flips its own winner's eligibility, so
    # the masked metric is maintained incrementally: picks are O(argmin),
    # not O(full eligibility rebuild) — decisions stay identical to the
    # sequential scalar loop because every updated entry takes exactly the
    # value a full rebuild would give it.
    metric = G.tput(st.total_occup, st.bvt, np) / st.prio

    def rebuild():
        limit = G.pu_limit(st.prio, st.queue_len, num_pus, np)
        eligible = (st.queue_len > 0) & (st.cur_occup < limit)
        if cap is not None:
            eligible = eligible & (st.cur_occup < cap)
        return limit, np.where(eligible, metric, G.BIG)

    limit, masked = rebuild()
    for j in range(k):
        i = int(np.argmin(masked))
        if masked[i] >= G.BIG:      # nothing eligible
            break
        picks[j] = i
        st.queue_len[i] -= 1
        st.cur_occup[i] += 1
        if st.queue_len[i] == 0:    # non-empty set shrank: limits change
            limit, masked = rebuild()
        else:
            ok = st.cur_occup[i] < limit[i] and (
                cap is None or st.cur_occup[i] < cap[i])
            masked[i] = metric[i] if ok else G.BIG
    return picks


def select_rr(rr_ptr: int, queue_len: np.ndarray, mask=None) -> tuple:
    """Round-robin baseline (paper Fig. 4/9).  Returns (idx, new_ptr)."""
    idx, ptr = G.select_rr(rr_ptr, queue_len, np, mask=mask)
    return int(idx), int(ptr)


# ---------------------------------------------------------------------------
# tensor surface (float32/int32 state on the caller's device)
# ---------------------------------------------------------------------------
def init_state_torch(priorities, device="cuda") -> dict:
    p = torch.as_tensor(priorities, dtype=torch.float32, device=device)
    T = p.shape[0]
    return {
        "prio": p,
        "total_occup": torch.zeros(T, dtype=torch.float32, device=device),
        "bvt": torch.zeros(T, dtype=torch.float32, device=device),
        "cur_occup": torch.zeros(T, dtype=torch.int32, device=device),
        "queue_len": torch.zeros(T, dtype=torch.int32, device=device),
    }


def _xp(st: dict):
    return G.torch_namespace(st["prio"].device)


def advance_torch(st: dict, dt) -> dict:
    xp = _xp(st)
    total_occup, bvt = G.advance(
        st["queue_len"], st["cur_occup"], st["total_occup"], st["bvt"],
        torch.as_tensor(dt, dtype=torch.float32, device=xp.device), xp)
    return dict(st, total_occup=total_occup, bvt=bvt)


def pu_limit_torch(st: dict, num_pus: int) -> torch.Tensor:
    return G.pu_limit(st["prio"], st["queue_len"], num_pus,
                      _xp(st)).to(torch.int32)


def select_torch(st: dict, num_pus: int) -> torch.Tensor:
    """Returns idx (int32, -1 if none eligible)."""
    return G.select(st["prio"], st["queue_len"], st["cur_occup"],
                    st["total_occup"], st["bvt"], num_pus,
                    _xp(st)).to(torch.int32)


def select_k_torch(st: dict, num_pus: int, k: int, cap=None):
    """The k winners of one round: ``select_round``'s transition k times
    (the winner's queue drained by one and its occupancy charged).

    Returns ``(picks, new_state)`` — picks is a (k,) int32 tensor,
    -1-padded; the new state carries the drained queue lengths and
    charged occupancies.
    """
    xp = _xp(st)
    ql, co = st["queue_len"], st["cur_occup"]
    if cap is not None:
        cap = torch.as_tensor(cap, device=xp.device)
    picks = []
    for _ in range(k):
        idx = G.select(st["prio"], ql, co, st["total_occup"], st["bvt"],
                       num_pus, xp, cap=cap)
        hot = xp.arange(ql.shape[0]) == idx      # idx -1 matches nothing
        ql = ql - hot.to(ql.dtype)
        co = co + hot.to(co.dtype)
        picks.append(idx)
    return (torch.stack(picks).to(torch.int32),
            dict(st, queue_len=ql, cur_occup=co))


# ---------------------------------------------------------------------------
# Deficit Weighted Round Robin (IO arbitration — paper §5.1 step 5, §6.2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DWRRState:
    weights: np.ndarray        # (Q,) float
    deficit: np.ndarray        # (Q,) float — bytes of credit
    ptr: int = 0

    @classmethod
    def create(cls, weights) -> "DWRRState":
        w = np.asarray(weights, np.float64)
        return cls(weights=w, deficit=np.zeros_like(w))


def dwrr_select(st: DWRRState, head_size: np.ndarray, pending: np.ndarray,
                quantum: float) -> int:
    """Pick the next queue whose head fragment fits its deficit.

    head_size: (Q,) bytes; pending: (Q,) bool.  Returns queue idx (its
    deficit is charged) or -1 if nothing pending.  See
    ``sched_generic.dwrr_select`` for the O(1) top-up semantics.
    """
    idx, deficit, ptr = G.dwrr_select(
        st.weights, st.deficit, st.ptr, np.asarray(head_size, np.float64),
        np.asarray(pending, bool), float(quantum), np)
    st.deficit = deficit
    st.ptr = int(ptr)
    return int(idx)


def dwrr_select_k(st: DWRRState, head_size: np.ndarray, counts: np.ndarray,
                  quantum: float, k: int) -> np.ndarray:
    """Batch DWRR: up to k grants of one arbitration round.

    ``counts`` (int array) holds the number of queued fragments per
    queue and is decremented in place as grants are issued; the deficit
    state advances exactly as k sequential ``dwrr_select`` calls would.
    Returns a (k,) int64 array of queue indices, -1-padded.
    """
    picks = np.full(k, -1, np.int64)
    for j in range(k):
        i = dwrr_select(st, head_size, counts > 0, quantum)
        if i < 0:
            break
        counts[i] -= 1
        picks[j] = i
    return picks


def dwrr_state_torch(weights, device="cuda") -> dict:
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return {"weights": w, "deficit": torch.zeros_like(w),
            "ptr": torch.zeros((), dtype=torch.int32, device=device)}


def dwrr_select_torch(st: dict, head_size, pending, quantum):
    """One DWRR grant on tensors.  Returns ``(idx, new_state)``."""
    dev = st["weights"].device
    idx, deficit, ptr = G.dwrr_select(
        st["weights"], st["deficit"], st["ptr"],
        torch.as_tensor(head_size, dtype=torch.float32, device=dev),
        torch.as_tensor(pending, dtype=torch.bool, device=dev),
        torch.as_tensor(quantum, dtype=torch.float32, device=dev),
        G.torch_namespace(dev))
    return idx.to(torch.int32), dict(st, deficit=deficit,
                                     ptr=ptr.to(torch.int32))
