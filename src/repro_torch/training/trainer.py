"""Train-step factory: loss, gradient accumulation, optimizer.

``build_trainer(cfg)`` returns a ``Trainer`` whose ``train_step`` is
``(state, batch) -> (state, metrics)`` with:

  * cross-entropy over fp32 logits, + z-loss (+ the MoE aux term, 0 for
    the dense decoder), labels -1 masked;
  * gradient accumulation over ``grad_accum`` microbatches (the parameters'
    ``.grad`` sums them in order, fp32, then divides);
  * AdamW / Adafactor with a cosine schedule and global-norm clipping.

The step launches its work and returns: no value is read on the host, so
``metrics["loss"]`` stays a device tensor until the caller reads it.
The JAX package's sharding (``mesh``) is not ported: a mesh raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Model, build_model
from repro_torch.serving.serve_step import require_device
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_state import TrainState

Z_LOSS = 1e-4
MOE_AUX = 1e-2


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits fp32 (B,S,V); labels int (B,S), -1 = masked.
    Returns (summed loss, token count)."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)                        # (B,S)
    lab = torch.gather(logits, -1,
                       torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = (lse - lab) + Z_LOSS * torch.square(lse)
    nll = torch.where(mask, nll, 0.0)
    return torch.sum(nll), torch.sum(mask)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("sharded training (a mesh) is not ported "
                                  "yet: the port trains on one device")


def make_loss_fn(model: Model, cfg: ModelConfig, mesh=None):
    _no_mesh(mesh)

    def loss_fn(module, batch):
        logits, aux = model.forward(module, batch)
        loss_sum, n_tok = cross_entropy(logits, batch["labels"])
        loss = loss_sum / torch.clamp(n_tok, min=1).to(loss_sum.dtype)
        if cfg.moe is not None:
            loss = loss + MOE_AUX * aux / max(cfg.num_layers, 1)
        return loss, {"ntok": n_tok}
    return loss_fn


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    model: Model
    optimizer: OPT.Optimizer
    device: torch.device
    train_step: Callable[[TrainState, Dict[str, torch.Tensor]],
                         Tuple[TrainState, Dict[str, torch.Tensor]]]
    init_state: Callable[[int], TrainState]


def build_trainer(cfg: ModelConfig, mesh=None, *, total_steps: int = 10_000,
                  warmup_steps: int = 100, grad_accum: Optional[int] = None,
                  device="cuda") -> Trainer:
    _no_mesh(mesh)
    dev = require_device(device)
    model = build_model(cfg)
    opt = OPT.make_optimizer(cfg, total_steps, warmup_steps)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    loss_fn = make_loss_fn(model, cfg, mesh)

    def _grads(module, batch):
        """(mean loss, {name: fp32 grad}) over ``accum`` microbatches."""
        params = dict(module.named_parameters())
        for p in params.values():
            p.grad = None
        if accum <= 1:
            loss, _ = loss_fn(module, batch)
            loss.backward()
            return loss.detach(), {n: p.grad for n, p in params.items()}
        B = batch["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             "microbatches")
        mb = B // accum
        loss_sum = 0.0
        for i in range(accum):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _ = loss_fn(module, sub)
            loss.backward()               # .grad sums the microbatches
            loss_sum = loss_sum + loss.detach()
        grads = {n: p.grad.div_(accum) for n, p in params.items()}
        return loss_sum / accum, grads

    def train_step(state: TrainState, batch):
        module = state.params
        loss, grads = _grads(module, batch)
        with torch.no_grad():
            gnorm = OPT.global_norm(grads.values())
            params = dict(module.named_parameters())
            updates, new_opt = opt.update(grads, state.opt_state, params)
            OPT.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        new_state = TrainState(params=module, opt_state=new_opt,
                               step=state.step + 1,
                               err_feedback=state.err_feedback)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_state.step}
        return new_state, metrics

    def init_state(seed: int) -> TrainState:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        with torch.no_grad():
            module = model.init(gen)
        return TrainState.create(module, opt)

    return Trainer(cfg=cfg, model=model, optimizer=opt, device=dev,
                   train_step=train_step, init_state=init_state)
