"""Shared model building blocks on torch tensors.

Parameters live in ``nn.Module``s (see ``models/transformer.py``; the
gated ``MLP`` is here, shared by the dense layers and the MoE layers'
shared experts); the functions here are plain tensor code.  Norms, RoPE
and softmax run in fp32; matmuls run in ``cfg.dtype`` with the weights
(held in ``cfg.param_dtype``) cast at the point of use, as in the JAX
package.  Under a serving layout or a sharded train step
(``distributed/parallel.py``) the module holds this rank's shards and the
MLP, the embedding and the LM head compute on them.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, YaRNConfig
from repro_torch.distributed import parallel as PAR


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init helpers (random weights drawn from an explicit generator, on the
# generator's device)
# ---------------------------------------------------------------------------
class ShapeOnly:
    """Stands in for the generator to build a model on the meta device
    (the dry run): every weight gets its shape and dtype, and nothing is
    drawn or allocated."""
    device = torch.device("meta")


def generator(device, seed: int):
    """The generator a model's weights are drawn from, seeded; on the
    meta device a ``ShapeOnly``."""
    dev = torch.device(device)
    if dev.type == "meta":
        return ShapeOnly()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def randn(gen, shape) -> torch.Tensor:
    """N(0, 1) fp32 from ``gen`` on its device; empty on meta."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = randn(gen, (d_in, d_out))
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def conv_init(gen: torch.Generator, width: int, ch: int,
              dtype: torch.dtype) -> torch.Tensor:
    """Depthwise temporal-conv weight (width, ch), N(0, 1/width)."""
    w = randn(gen, (width, ch))
    return w.mul_(1.0 / math.sqrt(width)).to(dtype)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A module weight; serving needs no gradient (training turns it on)."""
    return torch.nn.Parameter(t, requires_grad=False)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = randn(gen, (vocab, d))
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) parameterization: init at zeros == identity
    return (normed * (1.0 + scale.float())).to(x.dtype)


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def row_product(x: torch.Tensor, w: torch.Tensor,
                partial: bool = True) -> torch.Tensor:
    """``x @ w`` for a weight cast to x's dtype at the point of use.
    ``partial``: w holds rows of a row-parallel weight, so the product is
    this rank's partial sum, in ``PAR.partial_dtype`` (fp32 in a sharded
    train step)."""
    dt = x.dtype
    acc = PAR.partial_dtype(dt) if partial else dt
    if acc == dt:
        return x @ w.to(dt)
    return x.to(acc) @ w.to(dt).to(acc)


def apply_mlp(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
              x: torch.Tensor, act: str, partial: bool = False
              ) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU).  On column slices of ``w_gate`` /
    ``w_up`` and the matching row slice of ``w_down`` (``partial``) it
    gives this slice's share of the output, which the shares sum to."""
    dt = x.dtype
    gate = act_fn(act)(x @ w_gate.to(dt))
    up = x @ w_up.to(dt)
    return row_product(gate * up, w_down, partial)


class MLP(torch.nn.Module):
    """The gated MLP's weights: a dense layer's MLP (``d_ff``) or an MoE
    layer's shared experts (``num_shared_experts * expert_d_ff``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, d_ff: int):
        super().__init__()
        pd, d = pdtype_of(cfg), cfg.d_model
        self.d_ff = d_ff
        self.w_gate = param(dense_init(gen, d, d_ff, pd))
        self.w_up = param(dense_init(gen, d, d_ff, pd))
        self.w_down = param(dense_init(gen, d_ff, d, pd))

    def partial(self) -> bool:
        """Whether this module holds a slice of the hidden dim (a serving
        or training rank's shard), so its output is a share to be summed
        over ``model``."""
        return self.w_down.shape[0] < self.d_ff

    def forward(self, x: torch.Tensor, act: str) -> torch.Tensor:
        if self.partial():
            y = apply_mlp(self.w_gate, self.w_up, self.w_down,
                          PAR.block_in(x, True), act, partial=True)
            return PAR.block_out(y, True, x.dtype)
        if PAR.seq_sharded():
            # whole weights on this rank's positions (the MLP mixes none)
            PAR.mark_partial(self.w_gate, self.w_up, self.w_down)
        return apply_mlp(self.w_gate, self.w_up, self.w_down, x, act)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device,
               yarn: Optional[YaRNConfig] = None) -> torch.Tensor:
    """(head_dim / 2,) inverse frequencies; under YaRN (``yarn.factor`` >
    1) DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``: a linear ramp
    over the frequency index, between the correction dims of
    ``beta_fast`` (floor) and ``beta_slow`` (ceil), from the extrapolated
    frequencies (fast rotations) to the interpolated ones (divided by
    ``factor``)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    extra = 1.0 / (theta ** exps)
    if yarn is None or yarn.factor <= 1.0:
        return extra
    inter = 1.0 / (yarn.factor * theta ** exps)
    low = max(math.floor(_yarn_dim(yarn.beta_fast, head_dim, theta,
                                   yarn.original_max_position)), 0)
    high = min(math.ceil(_yarn_dim(yarn.beta_slow, head_dim, theta,
                                   yarn.original_max_position)),
               head_dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp             # 1: extrapolated, 0: interpolated
    return inter * (1 - keep) + extra * keep


def _yarn_dim(rotations: float, dim: int, base: float,
              max_pos: int) -> float:
    """The rotary dim whose wavelength fits ``rotations`` turns into
    ``max_pos`` positions (``yarn_find_correction_dim``)."""
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature, 0.1 m ln(factor) + 1 (1 for factor
    <= 1)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def rope_mscale(yarn: YaRNConfig) -> float:
    """The factor YaRN puts on cos and sin: mscale(factor, mscale) over
    mscale(factor, mscale_all_dim) (1 for DeepSeek-V2, whose two are
    equal)."""
    return yarn_mscale(yarn.factor, yarn.mscale) \
        / yarn_mscale(yarn.factor, yarn.mscale_all_dim)


@functools.lru_cache(maxsize=16)
def mrope_section_ids(sections: Tuple[int, ...], half: int,
                      device) -> torch.Tensor:
    """(half,) index of the position stream each frequency reads: section
    i repeated ``sections[i]`` times, cut or padded with the last index
    to ``half`` (``jnp.repeat``'s ``total_repeat_length``).  Built and
    copied to ``device`` once per arguments: a copy from the host inside
    a call would wait for the card, and a CUDA graph cannot hold it.
    ``sections`` is a key of that cache, so a tuple."""
    ids = torch.repeat_interleave(torch.arange(len(sections)),
                                  torch.tensor(sections))[:half]
    if ids.numel() < half:
        ids = torch.cat([ids, ids[-1:].expand(half - ids.numel())])
    return ids.to(device)     # built on the host: no device sync


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Tuple[int, ...] = (),
                yarn: Optional[YaRNConfig] = None) -> torch.Tensor:
    """positions: (B, S) or (3, B, S) for M-RoPE -> angles (B, S, half)."""
    inv = rope_freqs(head_dim, theta, positions.device, yarn)
    if positions.dim() == 3:                                # M-RoPE (t, h, w)
        if not mrope_sections:
            positions = positions[0]
        else:
            sec_id = mrope_section_ids(tuple(mrope_sections),
                                       head_dim // 2, positions.device)
            # per frequency index, the position stream of its section
            pos_sel = positions.float()[sec_id]              # (half, B, S)
            return torch.einsum("hbs,h->bsh", pos_sel, inv)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor,
               mscale: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D/2) — NeoX rotate-half convention.
    ``mscale`` multiplies cos and sin (YaRN's ``rope_mscale``)."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# sinusoidal absolute positions (whisper backbone)
# ---------------------------------------------------------------------------
SINUSOID_ROWS = 1 << 16       # the decoder's table: positions clip into it


def sinusoidal_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Rows ``positions`` (any shape, int) of the parameter-free table
    ``sinusoidal_positions(SINUSOID_ROWS, d_model)``, fp32 (..., d_model):
    sin at the even columns, cos at the odd ones.  Positions clip to
    [0, SINUSOID_ROWS - 1] (a pad position -1 reads row 0), and each row
    is computed as the table computes it, so no table is built."""
    pos = positions.clamp(0, SINUSOID_ROWS - 1).float()[..., None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)
    angle = pos / torch.pow(10_000.0, dim / d_model)
    return torch.stack([torch.sin(angle), torch.cos(angle)],
                       dim=-1).reshape(*positions.shape, d_model)


def sinusoidal_positions(seq_len: int, d_model: int,
                         device="cpu") -> torch.Tensor:
    """(seq_len, d_model) fp32 table of parameter-free absolute
    positions."""
    return sinusoidal_at(torch.arange(seq_len, device=device), d_model)


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------
def _slice_rows(table: torch.Tensor, tokens: torch.Tensor,
                lo: int) -> torch.Tensor:
    """The rows of the tokens that fall in a vocabulary slice starting at
    ``lo`` (``table`` holds its rows), zero for the others."""
    idx = tokens.long() - lo
    inside = (idx >= 0) & (idx < table.shape[0])
    return table[idx.clamp(0, table.shape[0] - 1)] * inside[..., None]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Rows of the embedding.  A serving rank holding a slice of the
    vocabulary's rows looks up the tokens in it (zero elsewhere), and the
    slices' rows are summed over ``model``: exactly one rank holds each
    token.  A sharded train step over ``model`` > 1 always looks up so, in
    its rows or in its vocabulary slice of a whole table, and under
    ``seq`` keeps the sum of this rank's positions."""
    srv = PAR.serving()
    act = PAR.current()
    V = cfg.vocab_size
    if srv is not None and table.shape[0] < V:
        rows = _slice_rows(table, tokens, srv.vocab_slice(V).start)
        x = PAR.block_out(rows, True).to(dtype_of(cfg))
    elif srv is None and act is not None and act.vocab_group is not None:
        if table.shape[0] == V:
            PAR.mark_partial(table)
            table = table[act.vocab_slice]
        rows = _slice_rows(table, tokens, act.vocab_slice.start)
        x = PAR.block_out(rows, True).to(dtype_of(cfg))
    else:
        x = table[tokens.long()].to(dtype_of(cfg))
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(x: torch.Tensor, embed_table: torch.Tensor,
              head: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Tied (``head`` None: the embedding table, transposed) or untied
    (``head`` (d, V)) LM head; fp32 logits, soft-capped if configured.
    Under a sharded train step with a vocab-parallel head, or a serving
    layout over ``model``, only this rank's slice of the vocabulary
    (``distributed/parallel.py``); in training x enters as a
    column-parallel block's input (under ``seq``, the whole sequence)."""
    table = embed_table.T if head is None else head
    act = PAR.current()
    srv = PAR.serving()
    if act is not None and act.vocab_group is not None:
        x = PAR.block_in(x, True)
        if table.shape[1] == cfg.vocab_size:
            PAR.mark_partial(embed_table if head is None else head)
            table = table[:, act.vocab_slice]
    elif srv is not None and srv.model > 1 \
            and table.shape[1] == cfg.vocab_size:
        # a whole head (the vocabulary does not divide): this rank's slice
        table = table[:, srv.vocab_slice(cfg.vocab_size)]
    logits = (x @ table.to(x.dtype)).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
