"""RecurrentGemma-2B (Griffin). [arXiv:2402.19427]

26L, d_model 2560, pattern = 2x RG-LRU block : 1x local-attention block
(window 2048), 10 heads MQA kv=1 head_dim 256, GeGLU d_ff 7680,
lru_width 2560, vocab 256000.  Windowed + recurrent -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, RGLRU, LOCAL_ATTN

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,         # pattern of 3 repeated; last group truncated
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    window_size=2048,
    lru_width=2560,
    conv1d_width=4,
    mlp_act="gelu",
    scale_embeddings=True,
    tie_embeddings=True,
)
