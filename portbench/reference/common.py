"""Plain pieces the family references share: the RMS norm, the weight
products in the reference's precision or the control's, and TF32 held off.

Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """fp32 products stay fp32: TF32 off for matmul and cuDNN, restored
    after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with gain ``1 + scale``: the weights are stored as the gain
    less one, so that a stored 0 is the published init of 1."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest entry maps to 448), returned in fp32."""
    t = t.float()
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """How the reference multiplies activations by weights.

    ``fp32``: both operands in fp32 (TF32 off by the caller).  ``fp8``:
    the control, one step below the configuration's bf16: every weight
    product takes its activations rounded to e4m3 per row and its weight
    per output column, then multiplies in fp32.  Norms, attention, the
    scan and the residual stay fp32 in both."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x.float() @ w.float()
        return fp8_round(x, -1) @ fp8_round(w, 0)


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: u (L, C), w (W, C), b (C,);
    y[t] = b + sum_i w[i] u[t - (W - 1) + i], zero before the start."""
    W = w.shape[0]
    pad = torch.cat([u.new_zeros((W - 1, u.shape[1])), u.float()])
    y = b.float().expand_as(u).clone()
    for i in range(W):
        y = y + pad[i:i + u.shape[0]] * w[i].float()
    return y


PIECE = 1 << 30      # elements a draw call fills


def draw_normal(specs, gen: torch.Generator, device) -> dict:
    """Weights N(0, std^2) for ``specs`` [(name, shape, std)], drawn from
    ``gen`` into one flat fp32 buffer on ``device`` in a few large calls;
    each weight is a contiguous view of it."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    for lo in range(0, buf.numel(), PIECE):
        buf[lo:lo + PIECE].normal_(generator=gen)
    out, lo = {}, 0
    for (name, shape, std), n in zip(specs, sizes):
        out[name] = buf[lo:lo + n].view(shape).mul_(std)
        lo += n
    return out
