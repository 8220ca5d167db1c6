"""Configuration system: model architecture configs and input-shape specs.

Every supported architecture is a ``ModelConfig`` instance built by a
``configs/<arch>.py`` module exposing ``CONFIG`` (full size); the
registry in ``repro_torch.configs`` resolves ``--arch <id>`` strings and
derives the reduced, CPU-runnable ``smoke_config()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used in the per-layer pattern.  The transformer stack scans over
# repeated groups of these kinds (homogeneous scan bodies compile once).
# ---------------------------------------------------------------------------
GLOBAL_ATTN = "global"     # full (causal) attention
LOCAL_ATTN = "local"       # sliding-window attention
RGLRU = "rglru"            # RG-LRU recurrent block (recurrentgemma)
SSD = "ssd"                # Mamba-2 SSD block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 1
    num_shared_experts: int = 0
    expert_d_ff: int = 0            # per-expert hidden
    layer_period: int = 1           # MoE every `period` layers (1 = all)
    first_dense_layers: int = 0     # leading dense layers (deepseek style)
    router_dtype: str = "float32"
    capacity_factor: float = 1.25   # train-time token capacity per expert
    norm_topk_prob: bool = True     # renormalise the top-k weights to sum
    #                                 to 1 (DeepSeek-V2 publishes False)
    serve_impl: str = "gshard"      # one-device serving dispatch: gshard
    #                                 (capacity, drops) | grouped (dropless
    #                                 grouped products, no host sync)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = no q compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN rotary scaling (``rope_scaling`` of type ``yarn``, as
    DeepSeek-V2 publishes it).  ``factor`` 1 leaves the rotary embedding
    and the softmax scale as they are."""
    factor: float = 1.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block parameters."""
    state_dim: int = 128
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab_size: int = 512

    # --- attention ---------------------------------------------------------
    block_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)  # repeated to num_layers
    window_size: int = 0            # for LOCAL_ATTN blocks
    attn_softcap: float = 0.0       # gemma2 logit soft-capping (0 = off)
    final_softcap: float = 0.0      # gemma2 final-logit soft-capping
    qk_norm: bool = False           # qwen3 per-head RMS q/k norm
    qkv_bias: bool = False          # qwen1.5-style bias on qkv projections
    attn_scale: float = 0.0         # 0 => 1/sqrt(head_dim); gemma2 overrides
    rope_theta: float = 10_000.0
    use_rope: bool = True           # whisper backbone: sinusoidal abs. pos.
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) splits
    yarn: YaRNConfig = YaRNConfig()  # rotary scaling; factor 1 = none
    mla: Optional[MLAConfig] = None

    # --- mlp ----------------------------------------------------------------
    mlp_act: str = "silu"           # "silu" -> SwiGLU, "gelu" -> GeGLU
    moe: Optional[MoEConfig] = None

    # --- ssm / rglru --------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    lru_width: int = 0              # recurrentgemma RG-LRU width
    conv1d_width: int = 4           # recurrentgemma temporal conv

    # --- embeddings / head --------------------------------------------------
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma multiplies embeddings by sqrt(d)
    norm_eps: float = 1e-6
    use_post_norms: bool = False    # gemma2 post-attn/post-ffn norms

    # --- encoder-decoder (whisper) ------------------------------------------
    encoder_layers: int = 0         # >0 => encoder-decoder
    num_audio_frames: int = 1500    # encoder context length (stub frontend)
    frontend_stub: bool = False     # vlm/audio: inputs are embeddings

    # --- numerics / execution ----------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    serve_keep_fsdp: bool = False   # llama4-400B: weights stay data-sharded
    grad_accum: int = 1             # microbatch count per train step
    attn_impl: str = "chunked"      # chunked | pallas (the hand-written
    #                                 CUDA kernels) | naive
    attn_chunk: int = 512           # KV block for chunked/flash attention
    remat: str = "full"             # full | dots | none
    scan_layers: bool = True
    optimizer: str = "adamw"        # adamw | adafactor
    learning_rate: float = 3e-4

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(k in (SSD, RGLRU) for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally over unbounded context."""
        return GLOBAL_ATTN not in self.block_pattern

    def pattern_for_layers(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.num_layers))
        out = []
        for i in range(self.num_layers):
            if i < self.moe.first_dense_layers:
                out.append(False)
            else:
                # MoE on the last layer of each period group (llama4 style).
                out.append((i % self.moe.layer_period) == self.moe.layer_period - 1)
        return tuple(out)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM arch pairs with all four; skip rules are
# encoded in `cell_supported` below and documented in DESIGN.md.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# Archs allowed to run the 500k-decode cell (sub-quadratic / windowed).
LONG_CONTEXT_ARCHS = ("mamba2-370m", "recurrentgemma-2b", "gemma2-27b")


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(supported, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN.md)"
    return True, ""


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: shared + top-k routed only)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    moe_layers = sum(cfg.moe_layer_mask())
    expert_p = 3 * cfg.d_model * m.expert_d_ff
    inactive = moe_layers * (m.num_experts - m.top_k) * expert_p
    return int(total - inactive)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (matches models.registry init exactly)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total = emb
    pattern = cfg.pattern_for_layers()
    moe_mask = cfg.moe_layer_mask()
    for i, kind in enumerate(pattern):
        total += d if kind == SSD else 2 * d  # pre-norms (SSD has no MLP)
        if cfg.use_post_norms:
            total += 2 * d
        if kind in (GLOBAL_ATTN, LOCAL_ATTN):
            if cfg.mla is not None:
                m = cfg.mla
                qd = cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                total += d * qd if m.q_lora_rank == 0 else d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * qd
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
                total += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                total += cfg.num_heads * m.v_head_dim * d
            else:
                total += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                if cfg.qkv_bias:
                    total += cfg.q_dim + 2 * cfg.kv_dim
                if cfg.qk_norm:
                    total += 2 * cfg.head_dim
        elif kind == RGLRU:
            w = cfg.lru_width or d
            total += 2 * d * w + w * d          # x/gate in, out proj
            total += cfg.conv1d_width * w + w   # temporal conv
            total += 5 * w                      # lambda_ + a/i gate w,b diag params
        elif kind == SSD:
            s = cfg.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_ch = d_in + 2 * s.n_groups * s.state_dim
            total += d * (2 * d_in + 2 * s.n_groups * s.state_dim + nheads)  # in_proj
            total += s.conv_dim * conv_ch + conv_ch                          # conv1d
            total += nheads * 2 + nheads                                     # A_log, D, dt_bias
            total += d_in                                                    # norm
            total += d_in * d                                                # out_proj
        # mlp / moe
        if kind in (GLOBAL_ATTN, LOCAL_ATTN, RGLRU):
            if cfg.moe is not None and moe_mask[i]:
                m = cfg.moe
                total += d * m.num_experts                                   # router
                total += m.num_experts * 3 * d * m.expert_d_ff
                total += m.num_shared_experts * 3 * d * m.expert_d_ff
            else:
                total += 3 * d * cfg.d_ff
    total += d  # final norm
    if cfg.is_encoder_decoder:
        # encoder self-attn + mlp + norms, decoder adds cross-attention
        enc = cfg.encoder_layers * (
            4 * d * cfg.q_dim + 3 * d * cfg.d_ff + 2 * d
        ) + d
        cross = cfg.num_layers * (4 * d * cfg.q_dim + d)
        total += enc + cross
    return int(total)
