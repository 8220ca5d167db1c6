"""RG-LRU recurrent block (Griffin / RecurrentGemma). [arXiv:2402.19427]

Prefill runs the linear recurrence ``h_t = a_t h_{t-1} + b_t``: under
``attn_impl="pallas"`` through the hand-written CUDA scan kernel
(``kernels/ops.rglru_scan``, from the carried h; its plain version on
CPU tensors), under ``chunked`` as a plain-torch parallel prefix scan
(the JAX package's ``associative_scan`` path, ``Bc + A h0``).  Decode is
the O(1) update, plain torch, as in the JAX package.  Gates are diagonal
(per channel), as in the JAX package.

On a serving or training rank's shard (``distributed/parallel.py``) the
block computes its channels (``w_x`` / ``w_gate``, the conv, the gates
and the scan on the slice, ``w_out`` row-parallel).  The cache's conv
window and ``h`` are whole on every model rank: the rank reads its
channels of them and gathers the new ones over ``model``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as PAR
from repro_torch.models import layers as L
from repro_torch.models.ssm import causal_conv

_C = 8.0  # Griffin's fixed gate temperature


class RGLRU(nn.Module):
    """The RG-LRU mixer's weights (``init_rglru`` of the JAX package)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        w = cfg.lru_width or cfg.d_model
        pd, d, dev = L.pdtype_of(cfg), cfg.d_model, gen.device

        def full(v):
            return L.param(torch.full((w,), v, dtype=torch.float32,
                                      device=dev))
        self.w_x = L.param(L.dense_init(gen, d, w, pd))
        self.w_gate = L.param(L.dense_init(gen, d, w, pd))
        self.conv_w = L.param(L.conv_init(gen, cfg.conv1d_width, w, pd))
        self.conv_b = L.param(torch.zeros(w, dtype=pd, device=dev))
        self.lambda_ = full(2.0)
        self.a_gate_w = full(1.0)
        self.a_gate_b = full(0.0)
        self.i_gate_w = full(1.0)
        self.i_gate_b = full(0.0)
        self.w_out = L.param(L.dense_init(gen, w, d, pd))


def _gates(p: RGLRU, u: torch.Tensor):
    uf = u.float()
    r = torch.sigmoid(uf * p.a_gate_w + p.a_gate_b)
    i = torch.sigmoid(uf * p.i_gate_w + p.i_gate_b)
    log_a = -_C * F.softplus(p.lambda_) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the maps ``h -> a_t h + b_t`` along dim 1 in
    log2(S) doubling steps: returns (A, Bc) with ``h_t = Bc_t + A_t h0``."""
    A, Bc = a, b
    d, S = 1, a.shape[1]
    while d < S:
        Bc = torch.cat([Bc[:, :d], A[:, d:] * Bc[:, :-d] + Bc[:, d:]], 1)
        A = torch.cat([A[:, :d], A[:, d:] * A[:, :-d]], 1)
        d *= 2
    return A, Bc


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                            dtype=L.dtype_of(cfg), device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[dict] = None,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,d) -> (B,S,d).  ``valid`` (B,S): pad tokens get a=1, b=0
    (identity recurrence) so ragged chunk tails are exactly inert.  The
    new conv window and h are written into the cache's own tensors (a
    CUDA graph captured over the cache reads them there)."""
    # w_out row-parallel: this rank's channels (a serving or training
    # rank's shard)
    w, wl = cfg.lru_width or cfg.d_model, p.w_out.shape[0]
    split = wl < w
    x = PAR.block_in(x, split)
    dt = x.dtype
    gate = F.gelu(x @ p.w_gate.to(dt), approximate="tanh")
    u = x @ p.w_x.to(dt)
    conv_state = h0 = None
    if cache is not None:
        conv_state, h0 = cache["conv"], cache["h"]
        if split:               # whole on every model rank: this slice
            srv = PAR.serving()
            lo = srv.model_rank * wl
            conv_state = conv_state[..., lo:lo + wl]
            # the kernel takes h0 contiguous
            h0 = h0[:, lo:lo + wl].contiguous()
    vn = valid.sum(-1).to(torch.int32) if valid is not None else None
    u, new_conv = causal_conv(u, p.conv_w, p.conv_b, conv_state, act=False,
                              valid_n=vn)
    a, b = _gates(p, u)                               # (B,S,w) fp32
    if valid is not None:
        v = valid[..., None]
        a = torch.where(v, a, 1.0)
        b = torch.where(v, b, 0.0)

    if cache is not None and x.shape[1] == 1:
        h_last = a[:, 0] * h0 + b[:, 0]
        hs = h_last[:, None]
    elif cfg.attn_impl == "pallas":
        from repro_torch.kernels import ops as kops
        hs, h_last = kops.rglru_scan(a, b, h0)
    else:
        A, hs = prefix_scan(a, b)
        if h0 is not None:
            hs = hs + A * h0[:, None, :]
        h_last = hs[:, -1].contiguous()
    if cache is not None:
        if split:
            new_conv = srv.gather_cols(new_conv, w)
            h_last = srv.gather_cols(h_last, w)
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
    out = L.row_product(gate * hs.to(dt), p.w_out, split)
    return PAR.block_out(out, split, dt), cache
