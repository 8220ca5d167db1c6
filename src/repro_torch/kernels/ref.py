"""Plain PyTorch versions of the port's kernels (full-matrix forms).

Each is the same function as its kernel, written the straightforward way:
the CPU tests run it, ``ops`` takes it for a tensor that lies on the
CPU, and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import sched_generic as G

NEG_INF = -1.0e30


def decode_attention_ref(q, k, v, lengths, *, scale: float, window: int = 0,
                         cap: float = 0.0) -> torch.Tensor:
    """q: (B,1,Hq,D); k/v: (B,T,Hkv,D); lengths: (B,) valid cache entries.

    A key at index ``kpos`` counts when ``kpos < length`` (and, with a
    window, ``length - kpos <= window``).  Rows with ``length <= 0``
    attend to nothing and return exactly 0.  fp32 arithmetic; the output
    has q's dtype.
    """
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    kpos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.to(q.device).long()[:, None]
    mask = kpos < lens
    if window:
        mask &= lens - kpos <= window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask[:, None, None, :]
    o = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# WLBVT dispatch round (csrc/wlbvt_select.cu)
# ---------------------------------------------------------------------------
def _one_pick(k: int, prio, queue_len, cur_occup, total_occup, bvt, metric,
              free_k, num_pus: int, xp):
    """One masked pick across all replica rows; -1 where nothing is
    eligible or the row's grantable-PU budget ``free_k`` is spent."""
    idx = G.select_lanes(prio, queue_len, cur_occup, total_occup, bvt,
                         num_pus, xp, metric=metric)
    can = (idx >= 0) & (k < free_k)
    iv = torch.where(can, idx, 0)
    lane = xp.arange(queue_len.shape[-1])
    hot = (lane == iv[..., None]) & can[..., None]
    queue_len = queue_len - hot.to(queue_len.dtype)
    cur_occup = cur_occup + hot.to(cur_occup.dtype)
    pick = torch.where(can, idx, -1).to(torch.int32)
    return pick, queue_len, cur_occup


def wlbvt_select_rounds_ref(prio, queue_len, cur_occup, total_occup, bvt,
                            free_k, *, num_pus: int, max_picks: int):
    """One WLBVT dispatch round, the dense way: all ``max_picks`` picks
    are computed, none skipped — the kernel's bit-exact oracle.

    ``prio/total_occup/bvt`` float ``[R, T]``, ``queue_len``/``cur_occup``
    int32 ``[R, T]``, ``free_k`` int32 ``[R]`` (PUs grantable per row).
    Returns ``(picks [R, max_picks] int32 (-1 = no grant), queue_len',
    cur_occup')``.  Runs on any device; the metric is hoisted out of the
    pick loop (picks touch only ``queue_len``/``cur_occup``)."""
    xp = G.torch_namespace(prio.device)
    metric = G.tput(total_occup, bvt, xp) / prio
    picks = []
    for k in range(max_picks):
        pick, queue_len, cur_occup = _one_pick(
            k, prio, queue_len, cur_occup, total_occup, bvt, metric, free_k,
            num_pus, xp)
        picks.append(pick)
    R = prio.shape[0]
    out = (torch.stack(picks, dim=-1) if picks else
           torch.empty((R, 0), dtype=torch.int32, device=prio.device))
    return out, queue_len, cur_occup


def wlbvt_select_rounds_early_exit(prio, queue_len, cur_occup, total_occup,
                                   bvt, free_k, *, num_pus: int,
                                   max_picks: int):
    """``wlbvt_select_rounds_ref``'s values with early exit: a row that
    returns -1 can never pick again this round (its state did not
    change), so once every row stalls the remaining picks are all -1 and
    are skipped.  Deciding that reads a tensor on the host, so this form
    is for CPU tensors.  ``max_picks == 1`` (the sweep datapath's
    single-grant step) is one pick with no loop and no host read."""
    if prio.device.type != "cpu":
        raise ValueError("wlbvt_select_rounds_early_exit reads its picks "
                         "on the host: CPU tensors only")
    xp = G.torch_namespace(prio.device)
    metric = G.tput(total_occup, bvt, xp) / prio
    if max_picks == 1:
        pick, ql, co = _one_pick(0, prio, queue_len, cur_occup, total_occup,
                                 bvt, metric, free_k, num_pus, xp)
        return pick[:, None], ql, co
    picks = torch.full((prio.shape[0], max_picks), -1, dtype=torch.int32)
    for k in range(max_picks):
        pick, queue_len, cur_occup = _one_pick(
            k, prio, queue_len, cur_occup, total_occup, bvt, metric, free_k,
            num_pus, xp)
        picks[:, k] = pick
        if not bool((pick >= 0).any()):
            break
    return picks, queue_len, cur_occup
