"""Training CLI: data pipeline -> train loop -> checkpoints -> resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20

Runs on the card (``--device cuda``, the default; without a card it
raises) unless ``--device cpu`` asks for the plain versions on the CPU.
Attention takes the hand-written kernels (``attn_impl="pallas"``): the
flash-attention forward on every layer of every step and its backward
kernel for the gradient.  Weights are random, drawn from ``--seed``.

Fault tolerance as in the JAX package's train CLI: asynchronous checkpoints
with an atomic commit; ``--resume`` restarts from LATEST (parameters,
optimizer and data-iterator state); SIGTERM triggers a final save.
``run_training`` is the loop itself, for callers that build their own
config (``chip_smoke.py`` trains the full width at reduced depth).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple


def run_training(cfg, *, steps: int, seq_len: int, global_batch: int,
                 grad_accum: int = 1, ckpt_dir: str = "",
                 ckpt_every: int = 50, resume: bool = False, seed: int = 0,
                 log_every: int = 10, device="cuda",
                 stop: Optional[Dict] = None,
                 log: Callable[[str], None] = print
                 ) -> Tuple[object, List[Dict]]:
    """Train ``cfg`` for ``steps`` steps; returns (final TrainState, one
    record per logged step).  A record holds the step, its loss and grad
    norm, the host-clock seconds per step since the last log and the
    tokens per second over them.  Only a logging step reads the loss on
    the host (which waits for the card); other steps only launch work."""
    import torch

    from repro_torch.serving.serve_step import require_device
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.trainer import build_trainer

    dev = require_device(device)
    trainer = build_trainer(cfg, total_steps=steps, grad_accum=grad_accum,
                            device=dev)
    pipe = make_pipeline(cfg, seq_len, global_batch, seed=seed)
    state = trainer.init_state(seed)

    start_step = 0
    ckpt = CKPT.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if resume and ckpt_dir and CKPT.latest_step(ckpt_dir) is not None:
        state, extra = CKPT.load(ckpt_dir, state)
        pipe.restore(extra["data"])
        start_step = int(extra["step"])
        log(f"resumed from step {start_step}")

    stop = stop if stop is not None else {"flag": False}
    history: List[Dict] = []
    t_last, since = time.perf_counter(), 0
    pinned = dev.type == "cuda"
    for step in range(start_step, steps):
        # one copy to the device per step; from pinned memory it does not
        # wait for the card to finish the previous step
        batch = {k: (torch.from_numpy(v).pin_memory().to(dev,
                                                          non_blocking=True)
                     if pinned else torch.from_numpy(v))
                 for k, v in next(pipe).items()}
        state, metrics = trainer.train_step(state, batch)
        since += 1
        if (step + 1) % log_every == 0 or step + 1 == steps:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            now = time.perf_counter()
            step_s = (now - t_last) / since
            rec = dict(step=step + 1, loss=loss, grad_norm=gn, step_s=step_s,
                       tokens_per_s=global_batch * seq_len / step_s)
            history.append(rec)
            log(f"step {step + 1:5d}  loss {loss:.4f}  gnorm {gn:.3f}  "
                f"step_s {step_s:.3f}  tok/s {rec['tokens_per_s']:,.0f}")
            t_last, since = now, 0
        if ckpt and ((step + 1) % ckpt_every == 0 or stop["flag"]
                     or step + 1 == steps):
            ckpt.save(state, step + 1,
                      extra={"step": step + 1, "data": pipe.state()})
        if stop["flag"]:
            log("preempted: final checkpoint committed")
            break
    if ckpt:
        ckpt.wait()
    return state, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    stop = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *_: stop.update(flag=True))
    run_training(cfg, steps=args.steps, seq_len=args.seq_len,
                 global_batch=args.global_batch, grad_accum=args.grad_accum,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 resume=args.resume, seed=args.seed,
                 log_every=args.log_every, device=args.device, stop=stop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
