"""Load the JAX package's parameter tree into the port's modules.

The reference keeps its repeated layer groups stacked for ``lax.scan``
(``params["groups"]``: a tuple of per-position layer dicts whose leaves
carry a leading ``n_groups`` axis) beside unstacked ``front``/``tail``
lists.  ``params_from_jax`` unstacks them into the port's flat layer
list, so both packages compute the same function from the same weights;
``train_state_from_reference`` does the same for a whole training state.
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


def named_arrays(np_tree: dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """A tree shaped like the reference's parameters (the parameters
    themselves, AdamW's ``m`` / ``v``, or Adafactor's slots, whose dicts
    add a last name part) -> {port parameter name: array}, the stacked
    layer groups unstacked."""
    front, p, n_groups, tail = layer_layout(cfg)
    layers = list(np_tree.get("front", []))
    for g in range(n_groups):
        layers.extend(_take(np_tree["groups"][j], g) for j in range(p))
    layers.extend(np_tree.get("tail", []))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"parameter tree holds {len(layers)} layers, "
                         f"config wants {cfg.num_layers}")
    state: Dict[str, np.ndarray] = {}
    _flatten("", {k: np_tree[k] for k in ("embed", "final_norm")}, state)
    for i, lp in enumerate(layers):
        _flatten(f"layers.{i}.", lp, state)
    return state


def params_from_jax(np_tree: dict, cfg: ModelConfig,
                    device="cpu") -> Transformer:
    """Reference parameter tree (numpy leaves) -> ``Transformer`` on
    ``device`` holding exactly those weights."""
    state = named_arrays(np_tree, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)          # placeholder weights, overwritten below
    module = Transformer(cfg, gen)
    module.load_state_dict({k: torch.tensor(v)
                            for k, v in state.items()}, strict=True)
    return module


def _adafactor_slots(slots: dict, module: Transformer, cfg: ModelConfig,
                     device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's Adafactor slot tree -> {parameter name: slot dict},
    where the slots mean what the port's per-layer Adafactor keeps."""
    flat = named_arrays(slots, cfg)          # 'layers.0.norm1.v_row' ...
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        name, part = key.rsplit(".", 1)
        out.setdefault(name, {})[part] = torch.tensor(arr, device=device)
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        want = ({"v_row": shape[:-1], "v_col": shape[:-2] + shape[-1:]}
                if len(shape) >= 2 else {"v": shape})
        got = {k: tuple(t.shape) for k, t in out.get(name, {}).items()}
        if got != want:
            raise NotImplementedError(
                f"Adafactor slots of {name}: the reference keeps {got}, the "
                f"port {want}.  The reference factors its stacked layer "
                "groups (a norm scale stacked to (n_groups, d) is factored "
                "there, unfactored per layer here); its slots carry over "
                "only with scan_layers=False")
    return out


def train_state_from_reference(params: dict, opt_state: dict, step,
                               cfg: ModelConfig, device="cpu"):
    """The reference's ``TrainState`` (params, opt_state and step as numpy
    trees) -> the port's ``TrainState`` on ``device``.

    AdamW's ``m`` / ``v`` and Adafactor's slots carry the parameters' tree
    and go through the same name map.  The reference applies Adafactor to
    its stacked layer groups: with ``scan_layers`` a norm scale stacked to
    (n_groups, d) is factored there and per layer here, and the update's
    RMS clip spans a whole group.  Such slots have no per-layer
    counterpart and raise; with ``scan_layers=False`` every slot carries
    over and both packages take the same Adafactor step."""
    from repro_torch.training.train_state import TrainState
    module = params_from_jax(params, cfg, device)
    module.requires_grad_(True)
    opt: Dict[str, object] = {"step": torch.tensor(
        np.asarray(opt_state["step"]), dtype=torch.int32, device=device)}
    if "slots" in opt_state:
        opt["slots"] = _adafactor_slots(opt_state["slots"], module, cfg,
                                        device)
    else:
        for slot in ("m", "v"):
            opt[slot] = {k: torch.tensor(v, device=device) for k, v in
                         named_arrays(opt_state[slot], cfg).items()}
    return TrainState(params=module, opt_state=opt,
                      step=torch.tensor(np.asarray(step), dtype=torch.int32,
                                        device=device))
