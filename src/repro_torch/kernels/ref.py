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
                         cap: float = 0.0, positions=None) -> torch.Tensor:
    """q: (B,1,Hq,D); k/v: (B,T,Hkv,D); lengths: (B,) valid cache entries.

    A key counts when its position ``kpos`` satisfies ``0 <= kpos <
    length`` (and, with a window, ``length - kpos <= window``).  Without
    ``positions`` a key's position is its index; ``positions`` (B,T)
    int32 gives each key's stored position instead (a ring cache indexed
    by position mod T, -1 where nothing was written), so the query at
    position ``length - 1`` sees exactly the keys that ``naive_attention``
    lets it see.  Rows with ``length <= 0`` attend to nothing and return
    exactly 0.  fp32 arithmetic; the output has q's dtype.
    """
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    kpos = (torch.arange(T, device=q.device)[None, :] if positions is None
            else positions.to(q.device).long())
    lens = lengths.to(q.device).long()[:, None]
    mask = (kpos >= 0) & (kpos < lens)
    if window:
        mask &= lens - kpos <= window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask[:, None, None, :]
    o = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# SSD and RG-LRU scans (csrc/ssd_scan.cu, csrc/rglru_scan.cu)
# ---------------------------------------------------------------------------
def ssd_scan_ref(x, dt, A_log, B_mat, C_mat, init_state=None):
    """Sequential SSD recurrence (Mamba-2): the scan kernel's oracle.

    x: (B,S,H,P); dt: (B,S,H); A_log: (H,); B_mat/C_mat: (B,S,G,N), head
    h reading group ``h // (H/G)``; init_state: (B,H,P,N) or None (zero).
    ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t`` with
    ``A = -exp(A_log)``, all in fp32.  Returns (y (B,S,H,P) in x's dtype,
    final_state (B,H,P,N) fp32).
    """
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    A = -torch.exp(A_log.float())
    Bf = B_mat.float().repeat_interleave(rep, dim=2)            # (B,S,H,N)
    Cf = C_mat.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float().clone())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A[None, :])[..., None, None]
        h = h * decay + torch.einsum("bhn,bh,bhp->bhpn", Bf[:, t], dtf[:, t],
                                     xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def rglru_scan_ref(a, b, h0=None):
    """Sequential linear recurrence ``h_t = a_t h_{t-1} + b_t`` from
    ``h0`` (B,W) (zero when None).  a, b: (B,S,W) fp32.  Returns
    (h (B,S,W), h_last (B,W))."""
    h = (torch.zeros_like(a[:, 0]) if h0 is None else h0.float())
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


# ---------------------------------------------------------------------------
# flash attention, forward and backward (csrc/flash_attention{,_bwd}.cu)
# ---------------------------------------------------------------------------
def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 arithmetic, or fp64 for fp64 inputs (``gradcheck``)."""
    return torch.promote_types(x.dtype, torch.float32)


def _flash_scores(q, k, *, scale: float, causal: bool, window: int,
                  cap: float):
    """Folded scores ``(B, Hkv, S, G, T)`` of ``(q*scale) . k`` after the
    soft-cap, ``tanh(s/cap)`` (None without a cap) and the (S, T) mask."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    acc = _acc_dtype(q)
    qf = (q.to(acc) * scale).reshape(B, S, Hkv, G, D)
    s = torch.einsum("bshgd,bthd->bhsgt", qf, k.to(acc))
    t = None
    if cap:
        t = torch.tanh(s / cap)
        s = cap * t
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    return s, t, mask[None, None, :, None, :], qf


def flash_attention_ref(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, cap: float = 0.0):
    """q: (B,S,Hq,D), k/v: (B,T,Hkv,D) -> ``(o (B,S,Hq,D) in q's dtype,
    lse (B, Hkv, S*G) fp32)``.  Full-matrix softmax in fp32.

    The query heads of one KV head are folded position-major, row
    ``s*G + g``, as the kernel reads them; ``lse = m + log l`` per folded
    row.  Masked probabilities are exactly 0 and the output is
    ``acc / max(l, 1e-30)``, as in the Pallas kernel.  Differentiable:
    autograd of this function is the backward's second oracle."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    s, _, mask, _ = _flash_scores(q, k, scale=scale, causal=causal,
                                  window=window, cap=cap)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    o = torch.einsum("bhsgt,bthd->bshgd", p, v.to(p.dtype))
    o = o / torch.clamp(l, min=1e-30).permute(0, 2, 1, 3)[..., None]
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).reshape(B, Hkv, -1)
    return o.reshape(B, S, Hq, D).to(q.dtype), lse.float()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale: float,
                            causal: bool = True, window: int = 0,
                            cap: float = 0.0):
    """Gradients ``(dq, dk, dv)`` of ``flash_attention_ref``'s output
    from the saved ``o`` and ``lse``, the way the backward kernel forms
    them: ``P = exp(s - lse)`` (0 where masked), ``dV = P^T dO``,
    ``dP = dO V^T``, ``Delta = rowsum(dO * O)``, ``dS = P * (dP - Delta)``
    times ``1 - tanh^2(s/cap)`` under a soft-cap, ``dQ = scale dS K``,
    ``dK = dS^T (q*scale)``.  Each in its input's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, t, mask, qf = _flash_scores(q, k, scale=scale, causal=causal,
                                   window=window, cap=cap)
    acc = s.dtype
    lse = lse.to(acc).reshape(B, Hkv, S, G)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dof = do.to(acc).reshape(B, S, Hkv, G, D)
    of = o.to(acc).reshape(B, S, Hkv, G, D)
    dv = torch.einsum("bhsgt,bshgd->bthd", p, dof)
    dp = torch.einsum("bshgd,bthd->bhsgt", dof, v.to(acc))
    delta = (dof * of).sum(dim=-1).permute(0, 2, 1, 3)        # (B,Hkv,S,G)
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhsgt,bthd->bshgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhsgt,bshgd->bthd", ds, qf)
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
