"""Optimizers written out in torch (no torch.optim), as in the JAX package.

    opt = make_optimizer(cfg, total_steps)
    state = opt.init(params)                 # params: {name: tensor}
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)

Parameters, gradients and slots are dicts of tensors keyed by parameter
name (``dict(module.named_parameters())``).  Each update does the JAX
package's arithmetic in its order: global-norm clipping inside
``update``, weight decay on every parameter.  Unlike the JAX package's
functional update, the port updates in place, because at full width every
extra copy of the training state is another 8.7 GB: ``update`` writes the
slots in place, clips the gradients in place and returns the updates in
the gradients' buffers (float32 ones); ``apply_updates`` adds them to the
parameters in place.  The step counter is a device tensor, so no update
reads a value on the host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


# ---------------------------------------------------------------------------
# schedules / utilities
# ---------------------------------------------------------------------------
def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 100, min_ratio: float = 0.1):
    """lr(step) -> float32 tensor on step's device: linear warmup, then a
    cosine decay to ``min_ratio * base_lr``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``p <- (p in float32 + u)`` in p's dtype, in place."""
    for name, p in params.items():
        u = updates[name]
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_((p.float() + u).to(p.dtype))
    return params


def _put(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The update ``u``, stored in the gradient's buffer when it can be."""
    if g.dtype == torch.float32:
        return g.copy_(u)
    return u


def _step0(params: Tensors) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": {n: z(p) for n, p in params.items()},
                "v": {n: z(p) for n, p in params.items()},
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, st, params):
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = st["step"] + 1
        t = step.to(torch.float32)
        lr = lr_fn(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        updates = {}
        for name, g in grads.items():
            m, v, p = st["m"][name], st["v"][name], params[name]
            g32 = g.float()
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(torch.square(g32) * (1 - b2))
            den = (v / bc2).sqrt_().add_(eps)
            u = (m / bc1).div_(den)
            del den
            u.add_(weight_decay * p.float()).mul_(-lr)
            updates[name] = _put(g, u)
        return updates, {"m": st["m"], "v": st["v"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; Shazeer & Stern 2018)
# ---------------------------------------------------------------------------
def adafactor(lr_fn, *, decay_pow: float = 0.8, clip_threshold: float = 1.0,
              eps: float = 1e-30, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"v_row": torch.zeros(p.shape[:-1], **f32),
                        "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"slots": {n: one(p) for n, p in params.items()},
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, st, params):
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = st["step"] + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** (-decay_pow)
        lr = lr_fn(step)
        updates = {}
        for name, g in grads.items():
            slot, p = st["slots"][name], params[name]
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if _factored(g.shape):
                v_row = beta2 * slot["v_row"] + (1 - beta2) * g2.mean(-1)
                v_col = beta2 * slot["v_col"] + (1 - beta2) * g2.mean(-2)
                r = v_row / torch.clamp(v_row.mean(-1, keepdim=True), min=eps)
                vhat = r[..., None] * v_col[..., None, :]
                slot["v_row"].copy_(v_row)
                slot["v_col"].copy_(v_col)
            else:
                vhat = beta2 * slot["v"] + (1 - beta2) * g2
                slot["v"].copy_(vhat)
            del g2
            u = g32 * torch.rsqrt(torch.clamp(vhat, min=eps))
            del vhat
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = -lr * u
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            updates[name] = _put(g, u)
        return updates, {"slots": st["slots"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
def make_optimizer(cfg: ModelConfig, total_steps: int = 10_000,
                   warmup_steps: int = 100) -> Optimizer:
    lr_fn = cosine_schedule(cfg.learning_rate, total_steps, warmup_steps)
    if cfg.optimizer == "adafactor":
        return adafactor(lr_fn)
    if cfg.optimizer == "adamw":
        return adamw(lr_fn)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
