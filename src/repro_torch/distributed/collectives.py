"""Overlapped collectives on a process group (one mesh dim's group).

``collective_matmul_ag`` is the all-gather <-> matmul overlap ("collective
matmul", Wang et al.): instead of all-gathering the row-sharded weight
and then multiplying, each step multiplies the shard it holds while the
ring passes the next one on (``batch_isend_irecv``: rank r sends to r+1
and receives from r-1), so the product hides the transfer.

``reduce_scatter_matmul`` is the mirrored pattern for an output
projection: a ring reduce-scatter of the per-shard partial products.

These are the JAX package's shard_map bodies, with ``ppermute`` read as
the ring's send/receive pair and the axis index as the rank in the
group.  They take and return plain local tensors.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _ring_shift(t: torch.Tensor, group, shift: int = 1):
    """Start passing ``t`` from rank r to rank r + shift of ``group``;
    returns (the buffer that receives rank r - shift's tensor, the
    requests to wait on)."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    buf = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t.contiguous(), dst, group),
        dist.P2POp(dist.irecv, buf, src, group)])
    return buf, reqs


def _ring_pass(t: torch.Tensor, group) -> torch.Tensor:
    buf, reqs = _ring_shift(t, group)
    for q in reqs:
        q.wait()
    return buf


def collective_matmul_ag(x: torch.Tensor, w_shard: torch.Tensor,
                         group=None) -> torch.Tensor:
    """``x @ all_gather(w_shard)`` with the transfer overlapped.

    ``w_shard``: this rank's (d_in/n, d_out) rows of a row-sharded weight;
    ``x``: (..., d_in), the same on every rank of ``group``.  After i ring
    steps this rank holds the shard that started at rank (r - i) mod n."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    blk = w_shard.shape[0]
    acc = torch.zeros(x.shape[:-1] + (w_shard.shape[1],),
                      dtype=w_shard.dtype, device=w_shard.device)
    w = w_shard
    for i in range(n):
        pending = _ring_shift(w, group) if i < n - 1 else None
        src = (r - i) % n
        acc = acc + x[..., src * blk:(src + 1) * blk] @ w
        if pending is not None:
            buf, reqs = pending
            for q in reqs:
                q.wait()
            w = buf
    return acc


def reduce_scatter_matmul(x_shard: torch.Tensor, w_shard: torch.Tensor,
                          group=None) -> torch.Tensor:
    """Row-parallel matmul with a ring reduce-scatter.

    ``x_shard``: (..., d_in/n), the contraction dim sharded; ``w_shard``:
    the matching (d_in/n, d_out) rows.  Each rank's product is a
    full-width partial sum; the ring reduce-scatters them so that rank r
    ends with its fully reduced (..., d_out/n) column block r.  Rank q
    starts the buffer of block q - 1; a buffer that reaches rank r at step
    s started at rank r - s, so rank r adds block (r - s - 1) mod n."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    part = x_shard @ w_shard                                  # (..., d_out)
    if n == 1:
        return part
    blk = part.shape[-1] // n

    def chunk(j):
        return part[..., j * blk:(j + 1) * blk]

    buf = chunk((r - 1) % n)
    for s in range(1, n):
        buf = _ring_pass(buf, group)
        buf = buf + chunk((r - s - 1) % n)
    return buf


def all_gather_interleaved(shard: torch.Tensor, group,
                           tile_fn: Callable[[int, torch.Tensor],
                                             torch.Tensor]) -> torch.Tensor:
    """Applies ``tile_fn(i, shard_i)`` as shards arrive around the ring
    and sums the results; ``i`` is labelled (r + step) mod n, as in the
    JAX package."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    out = tile_fn(r, shard)
    cur = shard
    for i in range(1, n):
        cur = _ring_pass(cur, group)
        out = out + tile_fn((r + i) % n, cur)
    return out


def psum_pods_then_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """Hierarchical all-reduce (in place): within the pod first (``data``),
    then across pods, so one value a element crosses the pod boundary."""
    names = mesh.mesh_dim_names
    for axis in ("data", "pod"):
        if axis in names:
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x
