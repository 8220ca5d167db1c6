"""Mamba-2 SSD (state-space duality) block. [arXiv:2405.21060]

Prefill runs the chunked SSD scan: under ``attn_impl="pallas"`` the
hand-written CUDA kernel (``kernels/ops.ssd_scan``; its plain version on
CPU tensors), under ``chunked`` the plain-torch chunked form below
(``ssd_chunked``, the JAX package's model path).  Decode is the O(1)
recurrent update, plain torch, as in the JAX package.

Projections are kept separate (w_z / w_x / w_B / w_C / w_dt + per-stream
depthwise convs) with the JAX package's names, so its parameter tree
loads 1:1 (``weights.params_from_jax``).

On a serving or training rank's shard (``distributed/parallel.py``) the
block computes its heads: ``w_z`` / ``w_x`` / ``w_dt``, the x conv,
``A_log`` / ``D`` / ``dt_bias`` and ``gate_norm`` on the slice, ``w_B`` /
``w_C`` and their convs whole (one group), ``out_proj`` row-parallel.
The gated norm's sum of squares runs over every channel
(``PAR.model_sum``).  The cache's ``state`` holds this rank's heads; its
x conv window is whole on every model rank, so the rank reads its
channels and gathers the new window over ``model``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as PAR
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    gn = s.n_groups * s.state_dim
    return s, d_in, nheads, gn


class SSD(nn.Module):
    """The SSD mixer's weights (``init_ssd`` of the JAX package)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        s, d_in, nheads, gn = _dims(cfg)
        pd, d, dev = L.pdtype_of(cfg), cfg.d_model, gen.device
        self.w_z = L.param(L.dense_init(gen, d, d_in, pd))
        self.w_x = L.param(L.dense_init(gen, d, d_in, pd))
        self.w_B = L.param(L.dense_init(gen, d, gn, pd))
        self.w_C = L.param(L.dense_init(gen, d, gn, pd))
        self.w_dt = L.param(L.dense_init(gen, d, nheads, pd))
        for name, ch in (("x", d_in), ("B", gn), ("C", gn)):
            setattr(self, f"conv_{name}_w",
                    L.param(L.conv_init(gen, s.conv_dim, ch, pd)))
            setattr(self, f"conv_{name}_b",
                    L.param(torch.zeros(ch, dtype=pd, device=dev)))
        self.A_log = L.param(torch.log(torch.linspace(
            1.0, 16.0, nheads, dtype=torch.float32, device=dev)))
        self.D = L.param(torch.ones(nheads, dtype=torch.float32, device=dev))
        self.dt_bias = L.param(torch.zeros(nheads, dtype=torch.float32,
                                           device=dev))
        self.gate_norm = L.param(torch.zeros(d_in, dtype=pd, device=dev))
        self.out_proj = L.param(L.dense_init(gen, d_in, d, pd))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None, act: bool = True,
                valid_n: Optional[torch.Tensor] = None):
    """x: (B,S,C); w: (W,C) depthwise.  Returns (y, new_state (B,W-1,C)).

    ``valid_n`` (B,): only the first valid_n tokens of each row are real
    (ragged chunked prefill) — the carried state then ends at the last
    valid token instead of the last position."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([state, x], dim=1)                  # (B, S+W-1, C)
    wd = w.to(x.dtype)
    y = xx[:, 0:S] * wd[0]
    for i in range(1, W):
        y = y + xx[:, i:i + S] * wd[i]
    if valid_n is None:
        new_state = xx[:, S:]
    else:
        idx = valid_n.long()[:, None] + torch.arange(W - 1, device=x.device)
        new_state = torch.gather(
            xx, 1, idx[..., None].expand(-1, -1, xx.shape[-1]))
    y = y + b.to(x.dtype)
    return (F.silu(y) if act else y), new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) cumulative segment sums, -inf above the
    diagonal (masked before any exp)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A_log, B_mat, C_mat, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan in plain torch (the JAX package's model path).

    x: (B,S,H,P); dt: (B,S,H); A_log: (H,); B_mat/C_mat: (B,S,G,N);
    init_state: (B,H,P,N) or None.  Returns (y (B,S,H,P) in x's dtype,
    final_state (B,H,P,N) fp32).  fp32 internally; a ragged last chunk
    is padded with dt = 0, which is inert."""
    Bb, S_in, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    Q = min(chunk, S_in)
    pad = (-S_in) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, 0, 0, pad))
    S = S_in + pad
    nc = S // Q
    rep = H // G
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtf = dt.float().reshape(Bb, nc, Q, H)
    Bf = B_mat.float().repeat_interleave(rep, dim=2).reshape(Bb, nc, Q, H, N)
    Cf = C_mat.float().repeat_interleave(rep, dim=2).reshape(Bb, nc, Q, H, N)
    dA = dtf * (-torch.exp(A_log.float()))                   # (B,nc,Q,H)

    state = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        dAh = dA[:, c].transpose(1, 2)                        # (B,H,Q)
        Lmat = torch.exp(_segsum(dAh))                        # (B,H,Q,Q)
        scores = torch.einsum("bqhn,bkhn->bhqk", Cc, Bc) * Lmat
        y_intra = torch.einsum("bhqk,bkh,bkhp->bqhp", scores, dtc, xc)
        decay_in = torch.exp(torch.cumsum(dAh, dim=-1))       # (B,H,Q)
        y_inter = torch.einsum("bqhn,bhpn,bhq->bqhp", Cc, state, decay_in)
        rev = torch.flip(torch.cumsum(torch.flip(dAh, [-1]), dim=-1), [-1])
        decay_out = torch.exp(rev - dAh)                      # exp(sum_{j>i})
        state = state * torch.exp(dAh.sum(-1))[..., None, None] \
            + torch.einsum("bqhn,bhq,bqh,bqhp->bhpn", Bc, decay_out, dtc, xc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, P)[:, :S_in]
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A_log, B_mat, C_mat, state):
    """One-token recurrent update.  x: (B,1,H,P); state: (B,H,P,N)."""
    xf = x.float()[:, 0]                                      # (B,H,P)
    dtf = dt.float()[:, 0]                                    # (B,H)
    rep = xf.shape[1] // B_mat.shape[2]
    Bf = B_mat.float().repeat_interleave(rep, dim=2)[:, 0]    # (B,H,N)
    Cf = C_mat.float().repeat_interleave(rep, dim=2)[:, 0]
    dA = torch.exp(dtf * (-torch.exp(A_log.float()))[None, :])
    new_state = state * dA[..., None, None] + torch.einsum(
        "bhn,bh,bhp->bhpn", Bf, dtf, xf)
    y = torch.einsum("bhn,bhpn->bhp", Cf, new_state)
    return y[:, None].to(x.dtype), new_state


def init_ssd_cache(cfg: ModelConfig, batch: int, device) -> dict:
    s, d_in, nheads, gn = _dims(cfg)
    dt = L.dtype_of(cfg)

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "conv_x": z(batch, s.conv_dim - 1, d_in),
        "conv_B": z(batch, s.conv_dim - 1, gn),
        "conv_C": z(batch, s.conv_dim - 1, gn),
        "state": z(batch, nheads, s.head_dim, s.state_dim,
                   dtype=torch.float32),
    }


def gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float,
               width: int) -> torch.Tensor:
    """``L.rms_norm`` over all ``width`` channels of y (..., c) that holds
    c of them (this rank's slice when c < width): the sum of squares is
    summed over ``model`` before the slice is scaled."""
    if y.shape[-1] == width:
        return L.rms_norm(y, scale, eps)
    yf = y.float()
    var = PAR.model_sum(yf.square().sum(dim=-1, keepdim=True)) / width
    return (yf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(y.dtype)


def ssd_block(p: SSD, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[dict] = None,
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,d) -> (B,S,d).  cache None => training/prefill-from-zero.

    ``valid`` (B,S) bool: padding tokens (ragged chunk tails) get dt=0 —
    zero state contribution and unit decay, so they are exactly inert.
    The cache dict's entries are replaced by the new conv windows and
    state."""
    s, d_in, nheads, gn = _dims(cfg)
    # out_proj row-parallel: this rank's heads (a serving or training
    # rank's shard)
    dl, hl = p.out_proj.shape[0], p.A_log.shape[0]
    split = dl < d_in
    if split and (dl != hl * s.head_dim or s.n_groups != 1):
        raise ValueError(f"{cfg.name}: the SSD's {nheads} heads in "
                         f"{s.n_groups} groups do not split over model")
    x = PAR.block_in(x, split)
    if split:       # whole, feeding this rank's heads only
        PAR.mark_partial(p.w_B, p.w_C, p.conv_B_w, p.conv_B_b, p.conv_C_w,
                         p.conv_C_b)
    B, S, d = x.shape
    dt_ = x.dtype
    z = x @ p.w_z.to(dt_)
    xs_ = x @ p.w_x.to(dt_)
    B_in = x @ p.w_B.to(dt_)
    C_in = x @ p.w_C.to(dt_)
    dt_raw = x @ p.w_dt.to(dt_)

    srv = PAR.serving()
    lo = srv.model_rank * dl if split and srv is not None else 0
    vn = valid.sum(-1).to(torch.int32) if valid is not None else None
    convs = {}
    for name, u in (("x", xs_), ("B", B_in), ("C", C_in)):
        c = cache[f"conv_{name}"] if cache is not None else None
        if c is not None and name == "x" and split:
            c = c[..., lo:lo + dl]          # the window is whole
        convs[name] = causal_conv(u, getattr(p, f"conv_{name}_w"),
                                  getattr(p, f"conv_{name}_b"), c,
                                  valid_n=vn)
    xs = convs["x"][0].reshape(B, S, hl, s.head_dim)
    B_mat = convs["B"][0].reshape(B, S, s.n_groups, s.state_dim)
    C_mat = convs["C"][0].reshape(B, S, s.n_groups, s.state_dim)
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None, :])
    if valid is not None:
        dt = dt * valid[..., None].float()

    def scan(init_state):
        if cfg.attn_impl == "pallas":
            from repro_torch.kernels import ops as kops
            return kops.ssd_scan(xs, dt, p.A_log, B_mat, C_mat,
                                 chunk=s.chunk_size, init_state=init_state)
        return ssd_chunked(xs, dt, p.A_log, B_mat, C_mat, s.chunk_size,
                           init_state=init_state)

    if cache is None:
        y, _ = scan(None)
    else:
        if S == 1:
            y, new_state = ssd_decode_step(xs, dt, p.A_log, B_mat, C_mat,
                                           cache["state"])
        else:   # chunked prefill continuing from the carried state
            y, new_state = scan(cache["state"])
        cache["state"] = new_state
        for name in ("x", "B", "C"):
            cache[f"conv_{name}"] = convs[name][1]
        if split:
            cache["conv_x"] = srv.gather_cols(convs["x"][1], d_in)

    y = y + xs * p.D[None, None, :, None].to(dt_)
    y = y.reshape(B, S, dl)
    y = gated_norm(y * F.silu(z), p.gate_norm, cfg.norm_eps, d_in)
    return PAR.block_out(L.row_product(y, p.out_proj, split), split,
                         dt_), cache
