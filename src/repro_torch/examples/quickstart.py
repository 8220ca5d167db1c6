"""Quickstart: build a model, run a train step, serve a request — the
whole public API in one short script.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The model runs on the card (the default; without a card it raises)
through the hand-written kernels (``attn_impl="pallas"``): the flash
forward and backward in the three training steps, decode attention in
every decode step of the serve.  ``--device cpu`` runs their plain
versions on the CPU.
"""
import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.slo import SLOPolicy
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Engine, EngineConfig, ModelExecutor
from repro_torch.serving.request import Request
from repro_torch.serving.serve_step import require_device
from repro_torch.training.data import make_pipeline
from repro_torch.training.trainer import build_trainer


def model_config():
    """The reduced qwen3 config (swap any of the 10 archs) under the
    hand-written kernels."""
    return dataclasses.replace(smoke_config("qwen3-8b"), attn_impl="pallas")


def train(cfg, device, state=None, steps: int = 3):
    """Three train steps from ``state`` (default: the trainer's own
    initial state, seed 0); returns (state, [per-step metrics])."""
    trainer = build_trainer(cfg, total_steps=100, warmup_steps=5,
                            device=device)
    if state is None:
        state = trainer.init_state(0)
    pipe = make_pipeline(cfg, seq_len=64, global_batch=4)
    history = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to(trainer.device)
                 for k, v in next(pipe).items()}
        state, metrics = trainer.train_step(state, batch)
        history.append(metrics)
        print(f"  step {int(metrics['step'])}: "
              f"loss {float(metrics['loss']):.3f}")
    return state, history


def serve(cfg, device, params=None) -> Engine:
    """Two tenants (premium at 2x priority, standard) through the OSMOSIS
    engine over the model; ``params`` default to the executor's own
    random weights (seed 0)."""
    ecfg = EngineConfig(max_slots=4, max_len=128, prefill_chunk=16,
                        max_tenants=2)
    eng = Engine(ecfg, executor=ModelExecutor(cfg, ecfg, params=params,
                                              device=device))
    eng.create_ectx(0, SLOPolicy(priority=2.0, kv_quota_tokens=128 * 2),
                    name="premium")
    eng.create_ectx(1, SLOPolicy(priority=1.0, kv_quota_tokens=128 * 2),
                    name="standard")
    for t in (0, 1):
        eng.submit(Request(t, np.arange(1, 17, dtype=np.int32),
                           max_new_tokens=8))
    eng.run_until_idle()
    for r in eng.done:
        print(f"  tenant{r.tenant_id}: generated {r.generated} "
              f"(fct={r.fct} steps)")
    print(f"engine fairness (Jain, time-avg): "
          f"{eng.metrics()['jain_timeavg']:.3f}")
    return eng


def run(device="cuda"):
    """The whole script: a model, three train steps, a two-tenant serve.
    Returns (the steps' metrics, the engine)."""
    dev = require_device(device)
    cfg = model_config()

    # --- 1. a model ---------------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        module = build_model(cfg).init(gen)
    n = sum(p.numel() for p in module.parameters())
    print(f"model: {cfg.name}  ({n/1e6:.2f}M params at smoke scale)")
    del module

    # --- 2. three train steps -----------------------------------------------
    _, history = train(cfg, dev)

    # --- 3. serve two tenants through the OSMOSIS engine --------------------
    return history, serve(cfg, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the card)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
