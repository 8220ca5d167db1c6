"""Gemma-7B. [arXiv:2403.08295]

28L, d_model 3072, 16 heads (kv=16 => MHA), head_dim 256, GeGLU d_ff 24576,
vocab 256000, embeddings scaled by sqrt(d_model), tied.
"""
from repro_torch.configs.base import ModelConfig, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    block_pattern=(GLOBAL_ATTN,),
    mlp_act="gelu",
    scale_embeddings=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
