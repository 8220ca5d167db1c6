"""CodeQwen1.5-7B — Qwen1.5 architecture. [hf:Qwen/CodeQwen1.5-7B]

32L, d_model 4096, 32 heads (kv=32 => MHA), SwiGLU d_ff 13440, vocab 92416,
QKV bias (Qwen1.5 signature), RoPE theta 1e6, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    block_pattern=(GLOBAL_ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    tie_embeddings=False,
)
