"""Whisper-large-v3 backbone. [arXiv:2212.04356]

Encoder-decoder: 32L encoder + 32L decoder, d_model 1280, 20 heads
(kv=20 => MHA), d_ff 5120, vocab 51866.  The conv/mel frontend is a STUB:
input_specs() provides 1500 precomputed frame embeddings.  Deviations
(DESIGN.md §5): unified gated-GeGLU MLP stack and RMSNorm instead of
vanilla GELU-MLP/LayerNorm; sinusoidal positions (parameter-free).
Shape interpretation: seq_len = decoder length with a fixed 1500-frame
encoder context.
"""
from repro_torch.configs.base import ModelConfig, GLOBAL_ATTN

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder layers
    encoder_layers=32,
    num_audio_frames=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    block_pattern=(GLOBAL_ATTN,),
    mlp_act="gelu",
    tie_embeddings=True,
    frontend_stub=True,
    use_rope=False,
    rope_theta=10_000.0,
)
