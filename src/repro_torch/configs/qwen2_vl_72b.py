"""Qwen2-VL-72B. [arXiv:2409.12191]

80L, d_model 8192, 64 heads GQA kv=8, SwiGLU d_ff 29568, vocab 152064.
M-RoPE with (t, h, w) sections (16, 24, 24) over head_dim/2 = 64.
Vision ViT frontend is a STUB: input_specs() provides precomputed patch
embeddings merged into the token stream (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    block_pattern=(GLOBAL_ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    mlp_act="silu",
    tie_embeddings=False,
    frontend_stub=True,
    optimizer="adafactor",
)
