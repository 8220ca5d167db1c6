"""Qwen3-8B. [hf:Qwen/Qwen3-8B]

36L, d_model 4096, 32 heads GQA kv=8, SwiGLU d_ff 12288, vocab 151936,
per-head RMS qk-norm, no bias, RoPE theta 1e6, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    block_pattern=(GLOBAL_ATTN,),
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    tie_embeddings=True,
)
