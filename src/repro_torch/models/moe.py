"""Mixture-of-Experts FFN with the JAX package's two dispatch
implementations.

``gshard`` — capacity-based one-hot dispatch/combine products within
fixed-size token groups; tokens past an expert's capacity are dropped.
The serving and training steps run it, as in the JAX package.

``ragged`` — sort tokens by expert, then one grouped product per expert.
The reference computes these with ``jax.lax.ragged_dot``, outside any
Pallas kernel; here they are plain ``torch.matmul`` calls.

``grouped`` (the port's own, for one-device serving when
``cfg.moe.serve_impl`` asks for it) — ``ragged``'s function without its
host sync: the (token, choice) pairs sorted by expert on the device, the
per-expert offsets a device ``cumsum`` of their counts, the gate/up and
down products as grouped GEMMs over those offsets (``torch._grouped_mm``,
CUTLASS on sm90), and the combine gathered back into (token, choice)
order and weighted in fp32.  No capacity, no drops: a row's output
depends on that row alone, so a tenant's tokens do not depend on what
the other slots of a call hold.  Rows marked invalid (chunk tails,
inactive decode slots) are routed to no expert and come out zero.

With ``counting()`` open (the executor opens it when its engine traces),
each one-device MoE layer adds its routing counts (``COUNTERS``) to a
device tensor that goes back to the host with the call's tokens; with
a recorder bound (``telemetry.trace.bound()``) the routing of a layer is
a ``moe.route`` host span.

Under a serving layout (``distributed/parallel.py``) a rank holds the
experts of its block of the experts' axis (``model`` under the serve
rules, ``data`` under Llama-4's) and, where the expert hidden dim goes
over ``model``, its columns.  The routing and the capacity groups are
computed whole on every rank from the whole batch's rows, each rank
computes its experts only, and one all-reduce sums the weighted outputs,
so the tokens that drop are the one-device ones.

A sharded train step (``distributed/parallel.py``) computes the same way
with gradients: the rows of the whole microbatch are gathered across the
batch group, each ``model`` rank runs its E / model experts (and its
columns of the shared experts) on them, and the ranks' outputs are summed
over ``model``; the routing, the capacity groups and the load-balancing
loss are the whole microbatch's.  Experts that do not split over
``model`` compute whole on every rank.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as PAR
from repro_torch.models import layers as L
from repro_torch.telemetry import trace as TR

MOE_IMPL = ("gshard", "ragged")        # the JAX package's; grouped is
#                                         the port's own

# what ``counting()`` sums over a call's MoE layers, in the recorder's
# column order: the valid rows' (token, choice) assignments, the (layer,
# expert) pairs that computed at least one of them, the most rows one
# expert computed in one layer, and the assignments capacity dropped (0
# but under ``gshard``)
COUNTERS = TR.MOE_COLUMNS[1:]
_counts = threading.local()


class MoE(nn.Module):
    """Router (d, E), kept f32; stacked expert weights (E, d, f) /
    (E, f, d); the shared experts as one gated MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        m = cfg.moe
        pd = L.pdtype_of(cfg)
        d, f, E = cfg.d_model, m.expert_d_ff, m.num_experts

        def normal(shape, scale, dtype):
            return L.param(L.randn(gen, shape).mul_(scale).to(dtype))

        self.router = normal((d, E), 0.02, torch.float32)
        self.w_gate = normal((E, d, f), 1.0 / math.sqrt(d), pd)
        self.w_up = normal((E, d, f), 1.0 / math.sqrt(d), pd)
        self.w_down = normal((E, f, d), 1.0 / math.sqrt(f), pd)
        if m.num_shared_experts:
            self.shared = L.MLP(cfg, gen, m.num_shared_experts * f)


def router_topk(p: MoE, x2d: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (weights (T,k), experts (T,k) int64, aux_loss)."""
    m = cfg.moe
    logits = x2d.float() @ p.router                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # ``jax.lax.top_k``'s order: descending, ties to the lower index;
    # ``torch.topk`` does not promise that order, a stable sort does
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :m.top_k], idx[:, :m.top_k]
    if m.norm_topk_prob:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss, over every row
    T = x2d.shape[0]
    me = probs.mean(dim=0)                                        # (E,)
    ce = F.one_hot(idx[:, 0], m.num_experts).float().sum(dim=0) / T
    aux = m.num_experts * torch.sum(me * ce)
    return w, idx, aux


@contextlib.contextmanager
def counting(device):
    """Open the route counters for the MoE layers run inside: yields a
    zeroed (len(COUNTERS),) int64 tensor on ``device`` that each
    one-device MoE layer adds to, on the device (no host sync)."""
    acc = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
    _counts.acc = acc
    try:
        yield acc
    finally:
        _counts.acc = None


def _count(routed: torch.Tensor, per_expert: torch.Tensor) -> None:
    """Add one layer's counts: ``routed`` the valid rows' assignments,
    ``per_expert`` (E,) the rows each expert computed of them."""
    acc = getattr(_counts, "acc", None)
    if acc is None:
        return
    per_expert = per_expert.to(torch.int64)
    acc[0:1] += routed.to(torch.int64).reshape(1)
    acc[1:2] += (per_expert > 0).sum().reshape(1)
    torch.maximum(acc[2:3], per_expert.max().reshape(1), out=acc[2:3])
    acc[3:4] += (routed - per_expert.sum()).reshape(1)


def _expert_ffn(w_gate, w_up, w_down, h, act: str, acc=None):
    """h: (g, E, C, d) grouped tokens vs stacked expert weights (E, d, f);
    the last product in ``acc`` (a partial sum's dtype) when given."""
    g = L.act_fn(act)(torch.einsum("gecd,edf->gecf", h, w_gate))
    u = torch.einsum("gecd,edf->gecf", h, w_up)
    if acc is None or acc == h.dtype:
        return torch.einsum("gecf,efd->gecd", g * u, w_down)
    return torch.einsum("gecf,efd->gecd", (g * u).to(acc), w_down.to(acc))


def apply_moe_gshard(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                     capacity_factor: float = 0.0, group_size: int = 2048,
                     expert_lo: int = 0, shared: bool = True,
                     partial: bool = False,
                     valid: Optional[torch.Tensor] = None):
    """Grouped capacity-based dispatch (GShard).  x: (B,S,d) -> (B,S,d).

    Tokens are dispatched within groups of ``group_size`` rows: the
    position in an expert's queue (a cumsum over (token, choice), token
    major) and the capacity C = max(1, int(Gsz * top_k * cf / E)) are
    per group, so which tokens drop depends on the rows' order.  Every
    row counts: inactive decode slots and chunk tails take capacity too.
    The last group is padded with rows of expert -1, never kept.

    ``p`` may hold a block of the experts, from ``expert_lo`` (a serving
    or training rank's shard): the output is then their share alone, in
    ``PAR.partial_dtype`` when ``partial``; ``shared`` False leaves the
    shared experts out.  ``valid`` (B, S) marks the rows the counters
    count (every row still takes capacity)."""
    m = cfg.moe
    B, S, d = x.shape
    dt = x.dtype
    T = B * S
    k, E = m.top_k, m.num_experts
    x2d = x.reshape(T, d)
    tr = TR.bound()
    if tr is not None:
        tr.host_begin(TR.H_MOE_ROUTE)
    w, idx, aux = router_topk(p, x2d, cfg)
    cf = capacity_factor or m.capacity_factor

    Gsz = min(group_size, T)
    nG = -(-T // Gsz)
    pad = nG * Gsz - T
    if pad:
        x2d = F.pad(x2d, (0, 0, 0, pad))
        w = F.pad(w, (0, 0, 0, pad))
        idx = F.pad(idx, (0, 0, 0, pad), value=-1)
    C = max(1, int(Gsz * k * cf / E))

    xg = x2d.reshape(nG, Gsz, d)
    idxg = idx.reshape(nG, Gsz, k)
    wg = w.reshape(nG, Gsz, k)

    # position of each (token, choice) inside its expert queue, per group
    onehot = idxg[..., None] == torch.arange(E, device=x.device)  # (g,t,k,E)
    flat = onehot.reshape(nG, Gsz * k, E).to(torch.int32)
    pos = torch.cumsum(flat, dim=1) * flat - 1                    # (g,tk,E)
    pos_in_e = pos.reshape(nG, Gsz, k, E).amax(dim=-1)            # (g,t,k)
    keep = (pos_in_e < C) & (idxg >= 0)
    wk = wg * keep
    if getattr(_counts, "acc", None) is not None:
        mine = idxg >= 0
        if valid is not None:
            mine = mine & F.pad(valid.reshape(T).to(torch.int8),
                                (0, pad)).bool().reshape(nG, Gsz, 1)
        kept = onehot & (keep & mine)[..., None]
        _count(mine.sum(), kept.sum(dim=(0, 1, 2)))
    if tr is not None:
        tr.host_end()

    e_oh = onehot.to(dt)
    c_oh = F.one_hot(torch.clamp(pos_in_e, 0, C - 1).long(), C).to(dt)
    # a token's k experts are distinct, so each (t, e) sums one choice
    dispatch = torch.einsum("gtke,gtkc->gtec", e_oh * keep[..., None].to(dt),
                            c_oh)
    combine = torch.einsum("gtke,gtkc->gtec", e_oh * wk[..., None].to(dt),
                           c_oh)

    mine = slice(expert_lo, expert_lo + p.w_gate.shape[0])
    h = torch.einsum("gtec,gtd->gecd", dispatch[:, :, mine], xg)  # (g,E,C,d)
    acc = PAR.partial_dtype(dt) if partial else dt
    out_e = _expert_ffn(p.w_gate.to(dt), p.w_up.to(dt), p.w_down.to(dt),
                        h, cfg.mlp_act, acc)
    y = torch.einsum("gtec,gecd->gtd", combine[:, :, mine].to(acc), out_e)
    y = y.reshape(nG * Gsz, d)[:T].reshape(B, S, d)
    if m.num_shared_experts and shared:
        y = y + _shared(p, x, cfg)
    return y, aux


def apply_moe_ragged(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Sort by expert + one grouped product per expert.  x: (B,S,d).
    The group sizes are read on the host (one sync a call)."""
    m = cfg.moe
    B, S, d = x.shape
    dt = x.dtype
    T = B * S
    x2d = x.reshape(T, d)
    w, idx, aux = router_topk(p, x2d, cfg)

    flat_e = idx.reshape(-1)                                      # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    tok = torch.arange(T, device=x.device).repeat_interleave(m.top_k)[order]
    xs = x2d[tok]                                                 # (T*k, d)
    sizes = torch.bincount(flat_e, minlength=m.num_experts).tolist()

    w_gate, w_up, w_down = p.w_gate.to(dt), p.w_up.to(dt), p.w_down.to(dt)
    act = L.act_fn(cfg.mlp_act)
    outs = [(act(xe @ w_gate[e]) * (xe @ w_up[e])) @ w_down[e]
            for e, xe in enumerate(torch.split(xs, sizes))]
    o = torch.cat(outs)

    wsorted = w.reshape(-1)[order].to(dt)                         # (T*k,)
    y = torch.zeros((T, d), dtype=dt, device=x.device).index_add_(
        0, tok, o * wsorted[:, None])
    y = y.reshape(B, S, d)
    if m.num_shared_experts:
        y = y + _shared(p, x, cfg)
    return y, aux


def apply_moe_grouped(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                      valid: Optional[torch.Tensor] = None):
    """Dropless dispatch on grouped GEMMs, with no host sync.  x: (B,S,d);
    ``valid`` (B, S) or None: rows left out are routed to no expert and
    their routed output is zero (their shared experts' is computed)."""
    m = cfg.moe
    B, S, d = x.shape
    dt = x.dtype
    T, k, E = B * S, m.top_k, m.num_experts
    x2d = x.reshape(T, d)
    tr = TR.bound()
    if tr is not None:
        tr.host_begin(TR.H_MOE_ROUTE)
    w, idx, aux = router_topk(p, x2d, cfg)
    flat_e = idx.reshape(-1)                                      # (T*k,)
    keep = None
    if valid is not None:
        keep = valid.reshape(T, 1).expand(T, k).reshape(-1)
        flat_e = torch.where(keep, flat_e, E)     # sorts after every group
    order = torch.argsort(flat_e, stable=True)
    # the counts by a fixed-size scatter: ``bincount`` on the card reads
    # its input's largest value on the host
    counts = torch.zeros(E + 1, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e,
                                                   dtype=torch.int32))
    offs = torch.cumsum(counts[:E], 0, dtype=torch.int32)
    xs = x2d[order // k]                 # pair t*k + j belongs to token t
    if getattr(_counts, "acc", None) is not None:
        _count(counts[:E].sum(), counts[:E])
    if tr is not None:
        tr.host_end()

    g = L.act_fn(cfg.mlp_act)(torch._grouped_mm(xs, p.w_gate.to(dt),
                                                offs=offs))
    h = g * torch._grouped_mm(xs, p.w_up.to(dt), offs=offs)
    o = torch._grouped_mm(h, p.w_down.to(dt), offs=offs)
    # back to (token, choice) order; the products write no row past the
    # last offset (an invalid row's), so those are zeroed, not weighted
    o = torch.empty_like(o).index_copy_(0, order, o).view(T, k, d)
    if keep is not None:
        o = torch.where(keep.view(T, k, 1), o, 0)
    y = (o.float() * w[..., None]).sum(dim=1).to(dt).reshape(B, S, d)
    if m.num_shared_experts:
        y = y + _shared(p, x, cfg)
    return y, aux


def _shared(p: MoE, x: torch.Tensor, cfg: ModelConfig,
            partial: bool = False) -> torch.Tensor:
    s = p.shared
    return L.apply_mlp(s.w_gate, s.w_up, s.w_down, x, cfg.mlp_act, partial)


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              impl: str = "gshard", valid: Optional[torch.Tensor] = None):
    """Under a sharded train step whose batch is split over ranks, the
    rows of the whole microbatch are gathered first, so the routing, the
    capacity groups and the auxiliary loss are the unsharded ones; each
    rank keeps its rows of the output.  ``valid`` (B, S), one device
    only: the rows ``grouped`` computes and the counters count."""
    srv = PAR.serving()
    if srv is not None:
        return _apply_serving(p, x, cfg, impl, srv)
    act = PAR.current()
    if act is not None:
        return _apply_training(p, x, cfg, impl, act)
    return _apply(p, x, cfg, impl, valid)


def _apply_training(p: MoE, x: torch.Tensor, cfg: ModelConfig, impl: str,
                    act: PAR.ActivationMesh):
    """This rank's experts (and shared-expert columns) on the whole
    microbatch's rows, summed over ``model``; whole experts when they do
    not split.  The load-balancing loss is computed whole on every rank
    whose router gradient is summed, so its gradient is scaled by one
    over their number."""
    m = cfg.moe
    E_l, f_l = p.w_gate.shape[0], p.w_gate.shape[2]
    split = E_l < m.num_experts or f_l < m.expert_d_ff
    xm = PAR.block_in(x, split)
    xw = PAR.gather_rows(xm, act)
    if not split:
        y, aux = _apply(p, xw, cfg, impl)
        return (PAR.block_out(PAR.local_rows(y, act), False),
                PAR.scale_grad(aux, 1.0 / act.rows))
    if impl != "gshard":
        raise NotImplementedError(f"moe_impl {impl!r}: the sharded train "
                                  "step dispatches with gshard")
    PAR.mark_partial(p.router)
    lo = act.model_rank * E_l if E_l < m.num_experts else 0
    y, aux = apply_moe_gshard(p, xw, cfg, shared=False, expert_lo=lo,
                              partial=True)
    y = PAR.local_rows(y, act)
    if m.num_shared_experts:
        y = y + _shared(p, xm, cfg, partial=True)
    return (PAR.block_out(y, True, x.dtype),
            PAR.scale_grad(aux, 1.0 / (act.rows * act.model)))


def _apply_serving(p: MoE, x: torch.Tensor, cfg: ModelConfig, impl: str,
                   srv: PAR.ServeLayout):
    """This rank's experts on the whole batch's rows; one all-reduce over
    the axes that split the experts and their hidden dim (the shared
    experts' share added by one rank of each group that repeats it)."""
    if impl != "gshard":
        raise NotImplementedError(f"moe_impl {impl!r}: the serving mesh "
                                  "dispatches with gshard")
    m = cfg.moe
    E_l, f_l = p.w_gate.shape[0], p.w_gate.shape[2]
    e_axes = (srv.ep,) if E_l < m.num_experts else ()
    f_axes = ("model",) if f_l < m.expert_d_ff else ()
    xw = srv.gather_rows(x)
    y, aux = apply_moe_gshard(p, xw, cfg, shared=False,
                              expert_lo=srv.index(e_axes) * E_l)
    axes = set(e_axes) | set(f_axes)
    if m.num_shared_experts:
        s_axes = {"model"} if p.shared.partial() else set()
        sh = L.apply_mlp(p.shared.w_gate, p.shared.w_up, p.shared.w_down,
                         xw, cfg.mlp_act)
        if all(srv.coord.get(a, 0) == 0 for a in axes - s_axes):
            y = y + sh
        axes |= s_axes
    y = srv.all_reduce(y, [a for a in srv.sizes if a in axes])
    return srv.local_rows(y), aux


def _apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, impl: str,
           valid: Optional[torch.Tensor] = None):
    if impl == "ragged":
        return apply_moe_ragged(p, x, cfg)
    if impl == "grouped":
        return apply_moe_grouped(p, x, cfg, valid)
    return apply_moe_gshard(p, x, cfg, valid=valid)
