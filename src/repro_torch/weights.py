"""Load the JAX package's parameter tree into the port's modules.

The reference keeps its repeated layer groups stacked for ``lax.scan``
(``params["groups"]``: a tuple of per-position layer dicts whose leaves
carry a leading ``n_groups`` axis) beside unstacked ``front``/``tail``
lists.  ``params_from_jax`` unstacks them into the port's flat layer
list, so both packages compute the same function from the same weights.
The tree arrives as numpy arrays: this module never imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer, layer_layout


def _flatten(prefix: str, tree: dict, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{k}.", v, out)
        else:
            out[prefix + k] = np.asarray(v)


def _take(tree: dict, g: int) -> dict:
    return {k: (_take(v, g) if isinstance(v, dict) else np.asarray(v)[g])
            for k, v in tree.items()}


def params_from_jax(np_tree: dict, cfg: ModelConfig,
                    device="cpu") -> Transformer:
    """Reference parameter tree (numpy leaves) -> ``Transformer`` on
    ``device`` holding exactly those weights."""
    front, p, n_groups, tail = layer_layout(cfg)
    layers = list(np_tree.get("front", []))
    for g in range(n_groups):
        layers.extend(_take(np_tree["groups"][j], g) for j in range(p))
    layers.extend(np_tree.get("tail", []))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"parameter tree holds {len(layers)} layers, "
                         f"config wants {cfg.num_layers}")
    state: Dict[str, np.ndarray] = {
        "embed": np.asarray(np_tree["embed"]),
        "final_norm": np.asarray(np_tree["final_norm"]),
    }
    for i, lp in enumerate(layers):
        _flatten(f"layers.{i}.", lp, state)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)          # placeholder weights, overwritten below
    module = Transformer(cfg, gen)
    module.load_state_dict({k: torch.tensor(v)
                            for k, v in state.items()}, strict=True)
    return module
