"""Llama-4 Maverick 400B-A17B. [hf:meta-llama (family); interpreted]

48L, d_model 5120, 40 heads GQA kv=8, vocab 202048.  MoE every 2nd layer:
128 routed experts top-1 + 1 shared expert, expert d_ff 8192; interleaved
dense layers use d_ff 16384.  This interpretation hits ~401B total /
~17B active parameters, matching the 400b-a17b label (DESIGN.md §5).
Text backbone only; the early-fusion image frontend is stubbed.
Adafactor optimizer (HBM budget for 400B states, DESIGN.md §3).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    serve_keep_fsdp=True,
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,            # dense (non-MoE) layers
    vocab_size=202048,
    block_pattern=(GLOBAL_ATTN,),
    rope_theta=500_000.0,
    mlp_act="silu",
    moe=MoEConfig(num_experts=128, top_k=1, num_shared_experts=1,
                  expert_d_ff=8192, layer_period=2),
    tie_embeddings=False,
    optimizer="adafactor",
)
