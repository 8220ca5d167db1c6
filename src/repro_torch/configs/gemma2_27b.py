"""Gemma2-27B. [arXiv:2408.00118]

46L, d_model 4608, 32 heads GQA kv=16, GeGLU d_ff 36864, vocab 256000.
Alternating local(4096)/global attention, attn logit softcap 50, final
softcap 30, pre+post norms, embeddings scaled by sqrt(d_model), tied.
"""
from repro_torch.configs.base import ModelConfig, LOCAL_ATTN, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    block_pattern=(LOCAL_ATTN, GLOBAL_ATTN),
    window_size=4096,
    attn_scale=144.0 ** -0.5,  # query_pre_attn_scalar = d_model/num_heads
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu",
    scale_embeddings=True,
    use_post_norms=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    optimizer="adafactor",
)
