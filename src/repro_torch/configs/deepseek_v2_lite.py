"""DeepSeek-V2-Lite 16B. [arXiv:2405.04434]

27L, d_model 2048, 16 heads with MLA (kv_lora_rank 512, qk nope/rope
128/64, v 128), vocab 102400.  Layer 0 dense (d_ff 10944); layers 1..26
MoE: 64 routed experts top-6 + 2 shared, expert d_ff 1408.  ~15.9B total.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,       # MLA: all heads share the compressed latent
    head_dim=128,
    d_ff=10944,            # dense layer 0
    vocab_size=102400,
    block_pattern=(GLOBAL_ATTN,),
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  expert_d_ff=1408, layer_period=1, first_dense_layers=1),
    tie_embeddings=False,
)
