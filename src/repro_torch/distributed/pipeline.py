"""GPipe pipeline parallelism over the ``pod`` mesh axis.

Layers are split into ``num_stages`` contiguous chunks, one a rank of the
axis, and microbatches stream through in the GPipe schedule: fill,
steady state, drain, M + S - 1 ticks.  At tick t the stage s works on
microbatch t - s, takes its input from stage s - 1 (point-to-point) and
hands its output to stage s + 1; the last stage keeps the outputs and
broadcasts them to every stage at the end.  A stage with no microbatch
at a tick does nothing (the JAX package computes and masks there).

The module pipelines any ``apply_fn(stage_params, x) -> x``; the forward
only (no autograd across the sends).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def stage_params(params_stacked: Any, num_stages: int) -> Any:
    """Layer-stacked tensors (leading dim = layers) -> per-stage stacks
    (num_stages, layers_per_stage, ...)."""
    def split(x):
        L = x.shape[0]
        assert L % num_stages == 0, (L, num_stages)
        return x.reshape(num_stages, L // num_stages, *x.shape[1:])
    return _tree_map(split, params_stacked)


def gpipe(apply_fn: Callable[[Any, torch.Tensor], torch.Tensor], mesh,
          axis: str = "pod"):
    """Returns ``pipelined(params_staged, xs)``.

    ``params_staged``: the ``stage_params`` stacks (every rank passes the
    same tree and takes its own stage) ; ``xs``: (M, mb, ...) microbatch
    major, the same on every rank.  Returns (M, mb, ...) on every rank."""
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    stage = dist.get_rank(group)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < S - 1 else None
    last = dist.get_global_rank(group, S - 1)

    def pipelined(params_staged, xs: torch.Tensor) -> torch.Tensor:
        params_local = _tree_map(lambda p: p[stage], params_staged)
        M = xs.shape[0]
        outputs = torch.zeros_like(xs)
        sends = []
        for t in range(M + S - 1):
            mb = t - stage
            if not 0 <= mb < M:
                continue
            if prev is None:
                x_in = xs[mb]
            else:
                x_in = torch.empty_like(xs[mb])
                dist.recv(x_in, prev, group=group)
            y = apply_fn(params_local, x_in).contiguous()
            if nxt is None:
                outputs[mb] = y
            else:
                # the list keeps y alive until its send is done
                sends.append((dist.isend(y, nxt, group=group), y))
        for q, _ in sends:
            q.wait()
        if S > 1:
            dist.broadcast(outputs, last, group=group)
        return outputs

    return pipelined


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
