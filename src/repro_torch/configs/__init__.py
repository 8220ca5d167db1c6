"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

Every architecture of the JAX package's catalog is registered, the
encoder-decoder one (whisper-large-v3) included.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 re-export
    GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD,
    MLAConfig, MoEConfig, ModelConfig, SSMConfig, ShapeSpec, YaRNConfig,
    SHAPES, LONG_CONTEXT_ARCHS, cell_supported, param_count,
)

_ARCH_MODULES: Dict[str, str] = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen3-8b": "qwen3_8b",
    "gemma2-27b": "gemma2_27b",
    "gemma-7b": "gemma_7b",
    "mamba2-370m": "mamba2_370m",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-large-v3": "whisper_large_v3",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, few layers/experts, tiny
    vocab — runnable forward/serve step on the CPU."""
    cfg = get_config(name)
    pat = cfg.block_pattern
    n_layers = max(2, len(pat))            # at least one full pattern group
    repl = dict(
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=257,
        attn_chunk=64,
        window_size=min(cfg.window_size, 32) if cfg.window_size else 0,
        scan_layers=True,
        remat="none",
    )
    if cfg.mla is not None:
        repl["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                qk_nope_head_dim=16, qk_rope_head_dim=8,
                                v_head_dim=16)
    if cfg.moe is not None:
        repl["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            expert_d_ff=64)
    if cfg.ssm is not None:
        repl["ssm"] = SSMConfig(state_dim=16, conv_dim=4, expand=2,
                                head_dim=16, n_groups=1, chunk_size=16)
    if cfg.lru_width:
        repl["lru_width"] = 64
    if cfg.is_encoder_decoder:
        repl["encoder_layers"] = 2
        repl["num_audio_frames"] = 16
    return dataclasses.replace(cfg, **repl)
