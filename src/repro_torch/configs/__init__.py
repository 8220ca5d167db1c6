"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

Only architectures whose blocks the port has are registered; the other
names of the JAX package's catalog raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 re-export
    GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD,
    MLAConfig, MoEConfig, ModelConfig, SSMConfig, ShapeSpec,
    SHAPES, LONG_CONTEXT_ARCHS, cell_supported, param_count,
)

_ARCH_MODULES: Dict[str, str] = {
    "qwen3-8b": "qwen3_8b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

# in the JAX package's catalog, waiting for blocks the port lacks (MoE,
# MLA, untied heads, encoder-decoder, M-RoPE) or for a parity test of
# the blocks it has (gemma-7b, gemma2-27b)
_NOT_PORTED = (
    "codeqwen1.5-7b", "gemma2-27b", "gemma-7b",
    "llama4-maverick-400b-a17b", "deepseek-v2-lite-16b",
    "qwen2-vl-72b", "whisper-large-v3",
)


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; available: {list_archs()}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, few layers, tiny vocab —
    runnable forward/serve step on the CPU."""
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
    if cfg.ssm is not None:
        repl["ssm"] = SSMConfig(state_dim=16, conv_dim=4, expand=2,
                                head_dim=16, n_groups=1, chunk_size=16)
    if cfg.lru_width:
        repl["lru_width"] = 64
    return dataclasses.replace(cfg, **repl)
