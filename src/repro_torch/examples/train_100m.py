"""End-to-end training example: a ~100M-param qwen3-family model
trained for a few hundred steps on synthetic Markov data, with grad
accumulation and asynchronous checkpoints.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 2 \
        --seq-len 32 --global-batch 2 --device cpu

Trains on the card (the default; without a card it raises) through the
hand-written flash-attention forward and backward kernels
(``attn_impl="pallas"``); ``--device cpu`` runs their plain versions.
``--mesh DxM`` trains sharded over a (data, model) mesh whose ranks
``torchrun`` starts (``launch/mesh.py``; NCCL on the card, gloo with
``--device cpu``); a mesh that needs more ranks than the run has raises.
Checkpoints go to ``--ckpt-dir`` (default: a
directory under the system's temporary directory), one every 100 steps.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.data import make_pipeline
from repro_torch.training.trainer import build_trainer

CKPT_EVERY = 100


def config_100m():
    """qwen3 family scaled to ~100M params, under the hand-written
    kernels."""
    base = get_config("qwen3-8b")
    return dataclasses.replace(
        base, name="qwen3-100m", num_layers=6, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32_000,
        attn_chunk=256, learning_rate=6e-4, attn_impl="pallas")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--mesh", default="none")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_100m_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the card)")
    return ap.parse_args(argv)


def train(args) -> dict:
    """The training loop.  Returns the final ``state``, every step's
    ``losses`` (read from the device once, at the end), the host-clock
    ``wall_s`` of the loop and ``ckpt_stall_s``, the seconds each save
    held the loop (its copy to the host; the write runs on a thread)."""
    cfg = config_100m()
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import make_mesh, parse_mesh
        mesh = make_mesh(parse_mesh(args.mesh), ("data", "model"),
                         args.device)
    trainer = build_trainer(cfg, mesh=mesh, total_steps=args.steps,
                            warmup_steps=20, grad_accum=args.grad_accum,
                            device=args.device)
    state = trainer.init_state(0)
    n = sum(p.numel() for p in state.named_params().values())
    print(f"params: {n/1e6:.1f}M   mesh: {args.mesh}")

    dev = trainer.device
    pipe = make_pipeline(cfg, args.seq_len, args.global_batch, prefetch=True)
    ckpt = CKPT.AsyncCheckpointer(args.ckpt_dir)
    losses, stalls = [], []

    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipe).items()}
        state, m = trainer.train_step(state, batch)
        losses.append(m["loss"])
        if (step + 1) % 25 == 0:
            toks = args.global_batch * args.seq_len * (step + 1)
            print(f"step {step+1:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"tok/s {toks/(time.time()-t0):,.0f}")
        if (step + 1) % CKPT_EVERY == 0:
            t_save = time.perf_counter()
            ckpt.save(state, step + 1,
                      extra={"step": step + 1, "data": pipe.state()})
            stalls.append(time.perf_counter() - t_save)
    ckpt.wait()
    wall = time.time() - t0
    pipe.close()
    print(f"done; checkpoints in {args.ckpt_dir}")
    return {"state": state, "cfg": cfg,
            "losses": torch.stack(losses).tolist() if losses else [],
            "wall_s": wall, "ckpt_stall_s": stalls}


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
