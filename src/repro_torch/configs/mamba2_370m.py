"""Mamba2-370M — SSD (state-space duality). [arXiv:2405.21060]

48L, d_model 1024, attention-free, ssm_state 128, expand 2, head_dim 64,
vocab 50280.  Decode state is O(1) in context length -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, SSD

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,           # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,                # SSD blocks have no separate MLP
    vocab_size=50280,
    block_pattern=(SSD,),
    ssm=SSMConfig(state_dim=128, conv_dim=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    tie_embeddings=True,
    norm_eps=1e-5,
)
