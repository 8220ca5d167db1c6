"""Plain PyTorch versions of the port's kernels (full-matrix forms).

Each is the same function as its kernel, written the straightforward way:
the CPU tests run it, ``ops`` takes it for a tensor that lies on the
CPU, and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.osmosis_pspin import PSPIN
from repro_torch.core import sched_generic as G

NEG_INF = -1.0e30


def decode_attention_ref(q, k, v, lengths, *, scale: float, window: int = 0,
                         cap: float = 0.0, positions=None,
                         return_lse: bool = False):
    """q: (B,1,Hq,D); k/v: (B,T,Hkv,D); lengths: (B,) valid cache entries.

    A key counts when its position ``kpos`` satisfies ``0 <= kpos <
    length`` (and, with a window, ``length - kpos <= window``).  Without
    ``positions`` a key's position is its index; ``positions`` (B,T)
    int32 gives each key's stored position instead (a ring cache indexed
    by position mod T, -1 where nothing was written), so the query at
    position ``length - 1`` sees exactly the keys that ``naive_attention``
    lets it see.  Rows with ``length <= 0`` attend to nothing and return
    exactly 0.  fp32 arithmetic; the output has q's dtype.

    ``return_lse``: also the log-sum-exp of each head's counted scores
    (after scale and cap), (B, Hq) fp32, NEG_INF where no key counts, so
    that attentions over disjoint key sets combine exactly
    (``models/attention.py``'s length-sharded decode).
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
    o = o.reshape(B, 1, Hq, D).to(q.dtype)
    if not return_lse:
        return o
    any_key = mask.any(dim=-1)[:, None, None]
    lse = torch.where(any_key, torch.logsumexp(s, dim=-1), NEG_INF)
    return o, lse.reshape(B, Hq)


def decode_attention_split_ref(q, k, v, lengths, *, scale: float,
                               window: int = 0, cap: float = 0.0,
                               positions=None, splits: int = 1
                               ) -> torch.Tensor:
    """``decode_attention_ref``'s function in the kernel's split form.

    Each row's live range ``[kbeg, kend)`` (by index: ``[max(0, length -
    window), min(length, T))``; with positions: ``[0, T)``; empty when
    ``length <= 0``) is cut into ``splits`` parts of ``ceil(len /
    splits)`` keys, as each block of the kernel cuts it.  Each part gives
    its row max m, sum l and accumulator over the keys that count in it
    (m = NEG_INF, l = 0 where none does); the parts are combined in
    order, a part weighing ``exp(m_r - max m)`` where l > 0 and 0 where
    not.  fp32 arithmetic; the output has q's dtype."""
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    idx = torch.arange(T, device=q.device)[None, :]
    kpos = idx if positions is None else positions.to(q.device).long()
    length = lengths.to(q.device).long()[:, None]
    mask = (kpos >= 0) & (kpos < length)
    if window:
        mask &= length - kpos <= window
    live = length > 0
    if positions is None:
        kend = torch.where(live, length.clamp(max=T), 0)
        kbeg = (torch.where(live, (length - window).clamp(min=0), 0)
                if window > 0 else torch.zeros_like(kend))
    else:
        kend = torch.where(live, T, 0)
        kbeg = torch.zeros_like(kend)
    per = ((kend - kbeg).clamp(min=0) + splits - 1) // splits
    vf = v.float()
    ms, ls, accs = [], [], []
    for r in range(splits):
        sb = torch.minimum(kend, kbeg + r * per)
        se = torch.minimum(kend, sb + per)
        m_r = mask & (idx >= sb) & (idx < se)              # (B, T)
        sr = torch.where(m_r[:, None, None, :], s, NEG_INF)
        mx = sr.amax(dim=-1)                               # (B, Hkv, G)
        p = torch.exp(sr - mx[..., None]) * m_r[:, None, None, :]
        ms.append(mx)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgt,bthd->bhgd", p, vf))
    m = torch.stack(ms).amax(dim=0)
    o = torch.zeros_like(accs[0])
    lsum = torch.zeros_like(ls[0])
    for mx, l, acc in zip(ms, ls, accs):
        w = torch.where(l > 0, torch.exp(mx - m), 0.0)
        lsum = lsum + w * l
        o = o + w[..., None] * acc
    o = o / torch.clamp(lsum, min=1e-30)[..., None]
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


def _bf16_split(t):
    """fp32 -> (hi, lo), both bf16 values held in fp32: hi + lo keeps
    ~16 bits of t, as the tensor-core SSD kernel feeds an fp32 operand."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _lane_cumsum(a):
    """The tensor-core SSD kernel's inclusive cumsum over a chunk's rows
    (the last dim, at most 64), in its order: lane l adds rows 2l and
    2l + 1, the 32 lanes scan those sums by doubling (Hillis-Steele), and
    each lane adds its rows to the sum before it."""
    q = a.shape[-1]
    a = torch.nn.functional.pad(a, (0, 64 - q))
    a0, a1 = a[..., 0::2], a[..., 1::2]
    v = a0 + a1
    for o in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], dim=-1)
    c0 = torch.nn.functional.pad(v[..., :-1], (1, 0)) + a0
    c1 = c0 + a1
    return torch.stack([c0, c1], dim=-1).flatten(-2)[..., :q]


def ssd_scan_bf16_ref(x, dt, A_log, B_mat, C_mat, init_state=None, *,
                      chunk: int):
    """``ssd_scan_ref``'s function in the bf16 kernel's chunked form and
    rounding (``csrc/ssd_scan.cu``, x and B/C in bf16).

    Chunks of ``min(chunk, S, 64)`` rows.  In a chunk, with dA = dt A and
    cs its cumsum: P = (C B^T) o exp(cs_i - cs_j) o dt_j masked to j <= i;
    y = exp(cs_i) (C . state) + P x; state = state exp(cs_last) + x^T W
    with W = B o dt_j exp(cs_last - cs_j).  x, B and C go into the
    products as they are; the fp32 operands P, W and the carried state go
    in as a bf16 hi + lo pair (two products); every sum is fp32 and the
    state stays fp32 between chunks.  The cumsum is the kernel's
    (``_lane_cumsum``), in log2 units, and every exp an exp2.  Returns (y
    in x's dtype, final state fp32)."""
    Bb, S, H, P = x.shape
    rep = H // B_mat.shape[2]
    A = -torch.exp(A_log.float()) * 1.44269504
    xf, dtf = x.float(), dt.float()
    Bf = B_mat.float().repeat_interleave(rep, dim=2)            # (B,S,H,N)
    Cf = C_mat.float().repeat_interleave(rep, dim=2)
    state = (torch.zeros((Bb, H, P, Bf.shape[-1]), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float().clone())
    Q = min(chunk, S, 64)
    ys = []
    for s0 in range(0, S, Q):
        xs, ds = xf[:, s0:s0 + Q], dtf[:, s0:s0 + Q]
        Bs, Cs = Bf[:, s0:s0 + Q], Cf[:, s0:s0 + Q]
        q = xs.shape[1]
        cs = _lane_cumsum((ds * A).transpose(1, 2))             # (B,H,q)
        dsh = ds.transpose(1, 2)
        keep = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                     device=x.device))
        seg = torch.where(keep, cs[..., :, None] - cs[..., None, :],
                          -torch.inf)
        scores = torch.einsum("bihn,bjhn->bhij", Cs, Bs)
        pm = torch.where(keep, scores * torch.exp2(seg) * dsh[..., None, :],
                         0.0)
        p_hi, p_lo = _bf16_split(pm)
        y = (torch.einsum("bhij,bjhp->bihp", p_hi, xs)
             + torch.einsum("bhij,bjhp->bihp", p_lo, xs))
        s_hi, s_lo = _bf16_split(state)
        inter = (torch.einsum("bihn,bhpn->bihp", Cs, s_hi)
                 + torch.einsum("bihn,bhpn->bihp", Cs, s_lo))
        y = torch.exp2(cs).transpose(1, 2)[..., None] * inter + y
        last = cs[..., -1:]
        w = (dsh * torch.exp2(last - cs)).transpose(1, 2)        # (B,q,H)
        w_hi, w_lo = _bf16_split(Bs * w[..., None])
        state = (state * torch.exp2(last)[..., None]
                 + torch.einsum("bjhp,bjhn->bhpn", xs, w_hi)
                 + torch.einsum("bjhp,bjhn->bhpn", xs, w_lo))
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def rglru_scan_segments_ref(a, b, h0=None, *, seg_len: int, cluster: int,
                            warps: int):
    """``rglru_scan_ref``'s function in the kernel's segmented order
    (``csrc/rglru_scan.cu``; ``seg_len`` and ``cluster`` from
    ``kernels/rglru_scan.py::geometry``).

    The sequence is walked in tiles of ``cluster`` blocks of ``warps``
    segments of ``seg_len`` steps.  Each segment is scanned from zero
    (its product of a and its local h); each block composes its segments
    in order; the carry before a segment is the tile's carry taken
    through the earlier blocks' compositions, then the earlier segments'
    of its block; the segment is rerun from that carry, and the next
    tile's carry is the h of the tile's last step before S.  Steps past
    S are the identity (a = 1, b = 0).  fp32; returns (h (B,S,W), h_last
    (B,W))."""
    Bb, S, W = a.shape
    tile = cluster * warps * seg_len
    pad = -S % tile
    af = torch.cat([a.float(), a.new_ones((Bb, pad, W))], dim=1)
    bf = torch.cat([b.float(), b.new_zeros((Bb, pad, W))], dim=1)
    carry = a.new_zeros((Bb, W)) if h0 is None else h0.float()
    hs = []
    for s0 in range(0, S + pad, tile):
        at = af[:, s0:s0 + tile].reshape(Bb, cluster, warps, seg_len, W)
        bt = bf[:, s0:s0 + tile].reshape(Bb, cluster, warps, seg_len, W)
        seg_a = torch.ones_like(at[..., 0, :])
        seg_h = torch.zeros_like(seg_a)
        for t in range(seg_len):
            seg_h = at[..., t, :] * seg_h + bt[..., t, :]
            seg_a = seg_a * at[..., t, :]
        blk_a = torch.ones_like(seg_a[:, :, 0])
        blk_h = torch.zeros_like(blk_a)
        for j in range(warps):
            blk_h = seg_a[:, :, j] * blk_h + seg_h[:, :, j]
            blk_a = blk_a * seg_a[:, :, j]
        c_blk = [carry]
        for r in range(cluster - 1):
            c_blk.append(blk_a[:, r] * c_blk[-1] + blk_h[:, r])
        c = [torch.stack(c_blk, dim=1)]                      # (B, C, W)
        for j in range(warps - 1):
            c.append(seg_a[:, :, j] * c[-1] + seg_h[:, :, j])
        h = torch.stack(c, dim=2)                            # (B, C, w, W)
        out = []
        for t in range(seg_len):
            h = at[..., t, :] * h + bt[..., t, :]
            out.append(h)
        hs.append(torch.stack(out, dim=3).reshape(Bb, tile, W))
        last = (min(S, s0 + tile) - 1 - s0) // seg_len   # its segment
        carry = h[:, last // warps, last % warps]
    return torch.cat(hs, dim=1)[:, :S], carry


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


# ---------------------------------------------------------------------------
# the sweep datapath's scan (csrc/sweep_scan.cu)
# ---------------------------------------------------------------------------
# the state the scan hands back (the kernel writes exactly these)
SWEEP_STATE = ("now", "na", "seq", "free_pus", "rr_ptr", "queue_len",
               "cur_occup", "total_occup", "bvt", "fifo_head", "spent",
               "jain_acc", "jain_t")
# on the card the plain step's ~126 kernels are each shorter than their
# launch from Python, so there blocks of GRAPH_STEPS steps run as CUDA-graph
# replays (3.0 -> 0.23 ms a step of the 256-replica mix on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit, PERF.md); the sweep itself runs the
# kernel, and only the card's checks and timings run the plain step there
GRAPH_STEPS = 128
_WARM_STEPS = 2


def sweep_init_state(R: int, T: int, P: int, C: int, NB: int, n_arr,
                     fdt, device) -> dict:
    """The scan's empty state.  Slot arrays carry an inert pad at index P
    and the FIFO ring a discard column at index C (masked writes aim
    there, see ``sweep_scan_ref``); no per-tenant counters ride the state
    — they are all recoverable from the EQ/completion streams."""
    i32, i64 = torch.int32, torch.int64

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return {
        "now": z(R, fdt),
        "na": z(R, i64),
        "seq": torch.as_tensor(n_arr, dtype=i32, device=device).clone(),
        "free_pus": full((R,), P, i32),
        "rr_ptr": z(R, i64),
        "queue_len": z((R, T), i32),
        "cur_occup": z((R, T), i32),
        "total_occup": z((R, T), fdt),
        "bvt": z((R, T), fdt),
        "fifo_head": z((R, T), i64),
        "fifo_buf": z((R, T, C + 1), i64),
        "spent": z((R, T), fdt),
        # slot pairs: s_tf = (t_fin, t0) float, s_ps = (pkt-meta, seq)
        # int32 — paired so grant/free are single row writes
        "s_tf": torch.stack([full((R, P + 1), float("inf"), fdt),
                             z((R, P + 1), fdt)], dim=-1),
        "s_ps": torch.stack([full((R, P + 1), NB, i32),
                             full((R, P + 1), int(torch.iinfo(i32).max),
                                  i32)], dim=-1),
        "jain_acc": z(R, fdt),
        "jain_t": z(R, fdt),
    }


def sweep_scan_ref(data: dict, *, T: int, P: int, C: int, S: int,
                   scheduler: str, graph_steps: int = 0, select=None):
    """The sweep datapath's scan, the plain way: ``S`` steps of the PsPIN
    event loop over every replica row of ``data`` (``devicepath.scan_inputs``:
    arrivals ``[R, NB + 1]``, per-tenant ``[R, T]`` config, ``n_arr``),
    from the empty state, each step a few dozen PyTorch ops on the replica
    tensors, updated in place.  Returns ``(state, ys)``: the ``SWEEP_STATE``
    fields and the per-step records ``(eq_pack, t, comp_meta,
    comp_ktime)``, each ``[S, R]``.  ``csrc/sweep_scan.cu`` computes the
    same, bit for bit: a change to the step changes both.

    On the card, after ``_WARM_STEPS`` eager steps, whole blocks of
    ``graph_steps`` steps are CUDA-graph replays (0: every step eager).
    ``select``: the WLBVT round (default the dense plain version, which
    runs on any device; ``ops.wlbvt_select_rounds`` puts the round's
    kernel in the step).

    Single-grant theorem (what makes the step cheap): the host dispatch
    loop maintains the quiescence invariant "free_pus == 0 or nothing
    eligible" after every event.  An arrival adds exactly one packet (a
    new non-empty queue only *shrinks* other tenants' ``pu_limit``), a
    completion frees exactly one PU — so every event grants **at most
    one** PU under both wlbvt and rr, and the per-event dispatch is one
    WLBVT round with ``max_picks=1``, no loop.

    Slot arrays are sized ``P + 1``: index P is an inert pad (t_fin
    ``+inf``, seq sentinel) that masked writes aim at, so no gather-merge
    is needed on the no-op branch.  Likewise the FIFO ring is ``C + 1``
    wide with column C as the discard target.  Within a step every
    replica row writes one index of each array, so the in-place writes
    (``index_put_``, ``scatter_add_``) never collide.
    """
    select = select or wlbvt_select_rounds_ref
    dma_ns = PSPIN.cycles_ns(PSPIN.dma_setup_cycles)
    ns_per_cycle = PSPIN.ns_per_cycle
    wlbvt = scheduler == "wlbvt"
    i32, i64 = torch.int32, torch.int64
    PKT = (1 << 30) - 1                      # slot meta: pkt | kill<<30 |
    KILL = 1 << 30                           # budget-kill<<31

    def _pre(s, d, k):
        """Consume one event (or nothing): pick the earliest of the next
        arrival and the earliest slot finish, advance the BVT/Jain
        integrals to it, apply the event, emit the EQ/completion record.
        Everything the event reads (slot finish times, the completing
        slot's meta and start, the arrival's queue length and FIFO head)
        is read before the first in-place write."""
        eq_pack_k, t_k, comp_meta_k, comp_ktime_k = k["ys"]
        na = s["na"][:, None]
        ta = d["arr_t"].gather(1, na)[:, 0]
        tfin = s["s_tf"][:, :, 0]            # slot pairs: (t_fin, t0)
        tmin = torch.amin(tfin, dim=1)
        # completion candidate: lowest seq among the min-finish slots
        pc = torch.where(tfin == tmin[:, None], s["s_ps"][:, :, 1],
                         k["sent"]).argmin(dim=1, keepdim=True)
        is_arr = ta <= tmin                  # arrival seqs < completion seqs
        t_ev = torch.where(is_arr, ta, tmin)
        # horizon_live = min(horizon, largest finite): t_ev <= horizon
        # and t_ev < inf in one compare
        live = t_ev <= d["horizon_live"]
        t = torch.where(live, t_ev, s["now"], out=t_k)
        prio = d["prio"]
        # --- advance fold (Simulator._advance_to, pre-event state) ----
        # ``now`` doubles as the fold's last-advance time (the two are
        # always set together), so a dead step has dt = 0
        dt = (t - s["now"]).clamp_min_(0.0)
        ql = s["queue_len"]
        co = s["cur_occup"]
        act = (ql > 0) | (co > 0)
        occf = co.to(prio.dtype)
        # an inactive tenant has co == 0: its occupancy term is exactly 0
        s["total_occup"] += occf * dt[:, None]
        s["bvt"] += dt[:, None] * act
        x = occf / prio
        actn, s1, s2 = G.lane_sum(torch.stack([act.to(prio.dtype), x,
                                               x * x]))
        jain = torch.where(s2 > 0.0, s1 * s1 / (actn * s2), k["one"])
        two_act = actn >= 2.0
        s["jain_acc"] += jain * dt * two_act
        s["jain_t"] += dt * two_act
        # --- arrival branch (FMQ push: admit -> overflow -> ECN) ------
        ia = d["arr_tenant"].gather(1, na)
        qa = ql.gather(1, ia)
        head_a = s["fifo_head"].gather(1, ia)
        marr = (live & is_arr)[:, None]
        acc = marr & (qa < d["fifo_cap"])
        drop = marr ^ acc
        mark = acc & (qa >= d["ecn_m1"])     # qa + 1 >= ecn threshold
        # --- completion branch (tenant derived from the packet id) ----
        mcomp = live[:, None] ^ marr
        pk = s["s_ps"][:, :, 0].gather(1, pc)
        ic = d["arr_tenant"].gather(1, (pk & PKT).long())
        kflag = mcomp & ((pk & KILL) != 0)
        bkflag = mcomp & (pk < 0)
        # host op order: now - (t0 - dma_ns), NOT now - grant
        ktime = t[:, None] - (s["s_tf"][:, :, 1].gather(1, pc) - dma_ns)
        # --- apply (masked writes aim at the pad slot/column) ---------
        mc = mcomp.to(i32)
        ql.scatter_add_(1, ia, acc.to(i32))
        co.scatter_add_(1, ic, -mc)
        tail_w = torch.where(acc, torch.remainder(head_a + qa, C), k["C"])
        s["fifo_buf"].index_put_((k["ar"], ia[:, 0], tail_w[:, 0]),
                                 s["na"])
        # the freed slot keeps its stale seq: seqs are only consulted
        # among the tfin == tmin slots, and a freed slot sits at +inf
        # until the next grant overwrites both fields
        pc_w = torch.where(mcomp, pc, k["P"])
        tfin.scatter_(1, pc_w, float("inf"))
        s["free_pus"] += mc[:, 0]
        # --- per-step records (step order IS host heap-pop order, so
        # the completion stream needs no carried per-packet arrays; the
        # packed slot meta ships as-is, -1 = no completion) -------------
        torch.where(mcomp[:, 0], pk[:, 0], k["neg1"], out=comp_meta_k)
        torch.where(mcomp[:, 0], ktime[:, 0], k["zero"], out=comp_ktime_k)
        # --- EQ (at most one event per step; code | tenant<<3 packed):
        # 1 mark, 2 drop (arrivals), 3 kill, 4 budget kill (completions)
        code = torch.where(kflag, bkflag + 3, drop * 2 + mark)
        ten = torch.where(is_arr[:, None], ia, ic)
        eq_pack_k.copy_(((ten << 3) | code)[:, 0])
        s["na"] += marr[:, 0]
        s["now"].copy_(t)
        return t, torch.where(live, s["free_pus"], k["zero_i"])

    def _rr_pick(s, free_k, k):
        """Host `_dispatch` rr arm, single-grant form: the pointer only
        advances on an actual grant (host never probes with 0 free)."""
        ptr, ql, co = s["rr_ptr"], s["queue_len"], s["cur_occup"]
        idx, ptr1 = G.select_rr(ptr, ql, G.torch_namespace(ql.device))
        can = (idx >= 0) & (free_k > 0)
        hot = ((k["lane"] == idx[:, None]) & can[:, None]).to(i32)
        ql -= hot
        co += hot
        s["rr_ptr"] = torch.where(can, ptr1, ptr)
        return torch.where(can, idx, k["neg1_l"])

    def _apply_one(s, d, pick, t, k):
        """Host ``_pop_and_start`` for the (single) winner: FIFO pop,
        budget clamps (exact op order of the inlined BudgetLedger
        mirror), slot fill, ``(t_fin, seq)`` heap push."""
        won = (pick >= 0)[:, None]
        wi = won.to(i32)
        i = pick.clamp_min(0).long()[:, None]
        head_i = s["fifo_head"].gather(1, i)
        j = s["fifo_buf"][k["ar"], i[:, 0], torch.remainder(head_i[:, 0], C)]
        j = j[:, None]
        s["fifo_head"].scatter_add_(1, i, won.to(i64))
        comp = d["arr_comp"].gather(1, j)
        # per-tenant (klim, tlim); klim is +inf where there is no limit,
        # so ``comp > klim`` is the host's ``klim > 0 and comp > klim``
        klim = d["klim"].gather(1, i)
        kill1 = comp > klim
        comp = torch.where(kill1, klim, comp)
        tlim = d["tlim"].gather(1, i)
        remaining = tlim - s["spent"].gather(1, i)
        bk = (tlim > 0) & (comp > remaining)
        comp = torch.where(bk, remaining.clamp_min(0.0), comp)
        s["spent"].scatter_add_(1, i, comp * won)
        # any free slot (t_fin == +inf, the max; the pad P is the last):
        # the heap orders by (t_fin, seq), not by slot index
        slot = s["s_tf"][:, :, 0].argmax(dim=1, keepdim=True)
        sw = torch.where(won, slot, k["P"])[:, 0]
        t0v = t + dma_ns
        tfv = t0v + comp[:, 0] * ns_per_cycle
        j32 = j[:, 0].to(i32)
        meta = torch.where(bk[:, 0], j32 | k["kill_bk"],
                           torch.where(kill1[:, 0], j32 | KILL, j32))
        won = won[:, 0]
        s["s_tf"].index_put_((k["ar"], sw), torch.stack(
            [torch.where(won, tfv, k["inf"]), t0v], dim=-1))
        s["s_ps"].index_put_((k["ar"], sw), torch.stack(
            [meta, torch.where(won, s["seq"], k["sent"])], dim=-1))
        s["seq"] += wi[:, 0]
        s["free_pus"] -= wi[:, 0]

    def _step(s, d, k):
        t, free_k = _pre(s, d, k)
        if wlbvt:
            picks, ql2, co2 = select(
                d["prio"], s["queue_len"], s["cur_occup"],
                s["total_occup"], s["bvt"], free_k, num_pus=P,
                max_picks=1)
            pick = picks[:, 0]
            s["queue_len"], s["cur_occup"] = ql2, co2
        else:
            pick = _rr_pick(s, free_k, k)
        _apply_one(s, d, pick, t, k)

    def _replay_blocks(state, data, k, ys, B, start, n_blocks):
        """Steps ``start ..`` in whole blocks of ``B``: one CUDA graph
        captures B steps once and is replayed, so the ~126 small kernels
        of a step are launched as one graph, not one by one from
        Python.  The graph reads and writes the state's own tensors: the
        entries a step replaces (kernel outputs) are copied back into
        them at the end of the block.  The per-step records go to a block
        buffer, copied into ``ys`` after each replay.  Kernel launches
        (``select`` = ``ops.wlbvt_select_rounds``) are counted per replay:
        the kernels the capture recorded, once more for every replay (the
        capture itself runs nothing)."""
        from repro_torch.kernels import ops
        blk = tuple(torch.empty((B,) + tuple(y.shape[1:]), dtype=y.dtype,
                                device=y.device) for y in ys)
        base = dict(state)
        before = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(B):
                k["ys"] = tuple(b[i] for b in blk)
                _step(state, data, k)
            for key, t in base.items():
                if state[key] is not t:
                    t.copy_(state[key])
        state.update(base)
        per_replay = {n: ops.LAUNCHES[n] - before[n] for n in before}
        ops.LAUNCHES.update(before)
        for s0 in range(start, start + n_blocks * B, B):
            graph.replay()
            for n, c in per_replay.items():
                ops.LAUNCHES[n] += c
            for y, b in zip(ys, blk):
                y[s0:s0 + B].copy_(b)

    R, NB1 = data["arr_t"].shape
    dev = data["arr_t"].device
    fdt = data["prio"].dtype
    state = sweep_init_state(R, T, P, C, NB1 - 1, data["n_arr"], fdt, dev)

    def const(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    ys = (torch.empty((S, R), dtype=i32, device=dev),    # eq_pack
          torch.empty((S, R), dtype=fdt, device=dev),    # event time
          torch.empty((S, R), dtype=i32, device=dev),    # comp_meta
          torch.empty((S, R), dtype=fdt, device=dev))    # comp_ktime
    k = {"ar": torch.arange(R, device=dev),
         "lane": torch.arange(T, device=dev),
         "inf": const(float("inf"), fdt), "zero": const(0.0, fdt),
         "one": const(1.0, fdt), "zero_i": const(0, i32),
         "neg1": const(-1, i32), "neg1_l": const(-1, i64),
         "C": const(C, i64), "P": const(P, i64),
         "sent": const(int(torch.iinfo(i32).max), i32),
         "kill_bk": const(-(1 << 30), i32)}   # bits 30 and 31
    done = 0

    def eager(n):
        nonlocal done
        for step in range(done, done + n):
            k["ys"] = tuple(y[step] for y in ys)
            _step(state, data, k)
        done += n

    # the first steps run eagerly: they also fill every lazily made
    # constant and load every kernel before a capture
    eager(min(S, _WARM_STEPS))
    B = graph_steps if dev.type == "cuda" else 0
    if B and S - done >= B:
        n_blocks = (S - done) // B
        _replay_blocks(state, data, k, ys, B, done, n_blocks)
        done += n_blocks * B
    eager(S - done)
    return {name: state[name] for name in SWEEP_STATE}, ys
