"""Plain PyTorch versions of the port's kernels (full-matrix forms).

Each is the same function as its kernel, written the straightforward way:
the CPU tests run it, ``ops`` takes it for a tensor that lies on the
CPU, and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

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
